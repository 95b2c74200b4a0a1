"""Plain PyTorch / NumPy references that decide whether a run is correct."""
