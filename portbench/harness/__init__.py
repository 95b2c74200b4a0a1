"""Drivers, traffic, arithmetic and the output check of the benchmark."""
