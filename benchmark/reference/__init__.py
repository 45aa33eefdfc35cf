"""The benchmark's plain reference: PyTorch in fp32, written from the
published descriptions, importing nothing of the program under test."""
