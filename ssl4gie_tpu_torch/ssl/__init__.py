"""Self-supervised pretraining: the MAE model and its train step."""
