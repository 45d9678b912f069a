"""Training: train state and optimizer, CHN train and eval steps."""
