"""Training: two-group AdamW with the milestone schedule, checkpoints, and the
learning engine."""
