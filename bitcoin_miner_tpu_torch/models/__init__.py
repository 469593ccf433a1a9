"""The flagship miner model: chunked min-hash search step."""

from .miner_model import forward_step_example

__all__ = ["forward_step_example"]
