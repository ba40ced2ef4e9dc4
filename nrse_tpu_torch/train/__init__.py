"""The train steps (BYOL, the SER trainers), their schedules and eval
steps; checkpoints and early stopping; the two-phase SER loops."""
