"""Training substrate of the port: so far the synthetic data pipeline,
the serving launcher's prompt source. The optimizer, steps, checkpoints
and loop come with training (ROADMAP A14)."""
