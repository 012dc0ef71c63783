"""Training: the optimizer, schedules, the train step and the trainer."""
