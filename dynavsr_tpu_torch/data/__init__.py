"""Host-side data: sliding windows, colour, bicubic resize, frame IO, test datasets."""
