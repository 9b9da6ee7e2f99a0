"""The plain reference: float64 PyTorch from the configurations' data alone;
it imports nothing of the program."""
