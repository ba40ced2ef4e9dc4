"""The BYOL training step, its schedules and its eval step; checkpoints
and early stopping."""
