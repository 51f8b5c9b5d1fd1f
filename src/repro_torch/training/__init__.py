"""Training: AdamW (`optimizer`) and the train step (`train_loop`)."""
