from .autoregressive import autoregressive_rollout, rollout_starts

__all__ = ["autoregressive_rollout", "rollout_starts"]
