"""The port's LM side: ``layers`` (building blocks) and ``lm`` (the dense
family's model, KV cache and cached forward)."""
