"""The optimizer: two-group AdamW with the milestone schedule."""
