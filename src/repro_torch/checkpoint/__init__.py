"""Checkpoints in the reference's .npz layout (`checkpointer`)."""
