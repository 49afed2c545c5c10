"""Audio decode, write and resampling on the host."""
