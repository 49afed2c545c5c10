"""The benchmark's own code: cells and their files, the seeded songs, the
loops that drive the program, the trace, the frozen counts and the check."""
