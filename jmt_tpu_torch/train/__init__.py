"""The train and eval steps, their state and optimizers, and the
device preprocessing shared with serving."""
