"""Step factories; only the serving steps are ported so far (ROADMAP.md
Queue 1 item 2 ports the training step)."""
