"""Host utilities of the port: the logger, seeding and the wandb stub."""
