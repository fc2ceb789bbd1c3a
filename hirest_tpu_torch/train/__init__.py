"""Training: the multitask engine (train/trainer.py), its losses,
optimizers and prediction formatting, and caption-generator pretraining."""
