"""The port's LM side: ``layers`` (building blocks), ``lm`` (the dense
family's model, KV cache, cached forward and training forward) and
``names`` (the port's parameter names against the JAX package's tree)."""
