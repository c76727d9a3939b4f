"""The train and eval steps: forward, losses, backward and the guarded AdamW
update; the inference forward."""
