"""The BYOL training step, its schedules and its eval step."""
