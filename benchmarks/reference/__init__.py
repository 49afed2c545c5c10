"""The plain reference of the benchmark: a frozen copy of the port's plain
code (numpy and PyTorch), each sequential decoder and the median as its plain
loop on every device, the WAV decode and resampler in numpy, the checkpoints
read by path. It imports nothing of the program."""
