"""Training of the port: optimizers and schedules (`optim`), the train
state (`state`) and the train / eval steps (`steps`)."""
