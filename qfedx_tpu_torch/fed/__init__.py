"""Federated learning: config, client sampling, local training, the round."""
