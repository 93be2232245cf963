"""Models: EDVR, TOFlow, DUF, MFDN, shared blocks, input conventions."""
