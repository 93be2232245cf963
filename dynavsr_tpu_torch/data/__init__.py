"""Host-side data: sliding windows, colour, bicubic resize, DUF's blur-matched
downsample, frame IO, the test sets and their factory."""
