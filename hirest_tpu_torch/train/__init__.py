"""The multitask engine (train/trainer.py); its inference half so far."""
