"""The plain references the runs are compared with: plain PyTorch in f32,
importing nothing of the program."""
