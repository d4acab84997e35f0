"""Train state, schedules and the train / eval steps."""
