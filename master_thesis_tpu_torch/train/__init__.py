"""Training: train state and optimizer (with gradient accumulation), the
CHN and DFPN train and eval steps, and the train loop with checkpoints and
logging."""
