"""The OpenAI-compatible HTTP frontend: `python -m dynamo_tpu_torch.frontend`."""
