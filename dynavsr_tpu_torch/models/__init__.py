"""Models: EDVR, MFDN, shared blocks, mod-padding."""
