"""Training on one device: the train-step builder (`train.py`)."""
