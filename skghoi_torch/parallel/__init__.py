"""The train step: forward, losses, backward and the guarded AdamW update."""
