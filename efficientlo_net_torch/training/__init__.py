"""Train state, schedules, the train / eval steps, checkpoints and the trainer."""
