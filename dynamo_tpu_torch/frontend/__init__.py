"""The request front end: the model card a worker publishes."""
