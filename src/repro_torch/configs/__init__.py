"""Model configurations the port runs (the ICU LSTM classifiers)."""
