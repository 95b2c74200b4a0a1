"""The portbench harness: one cell of the port's benchmark a run."""
