"""LSP configuration parameters.

Parity: reference ``lsp/params.go:8-35`` — defaults EpochLimit=5,
EpochMillis=2000, WindowSize=1.
"""

from __future__ import annotations

from dataclasses import dataclass

DEFAULT_EPOCH_LIMIT = 5
DEFAULT_EPOCH_MILLIS = 2000
DEFAULT_WINDOW_SIZE = 1


@dataclass
class Params:
    epoch_limit: int = DEFAULT_EPOCH_LIMIT
    epoch_millis: int = DEFAULT_EPOCH_MILLIS
    window_size: int = DEFAULT_WINDOW_SIZE

    @property
    def epoch_seconds(self) -> float:
        return self.epoch_millis / 1000.0

    def __str__(self) -> str:  # lsp/params.go:41-44
        return (
            f"[EpochLimit: {self.epoch_limit}, EpochMillis: {self.epoch_millis}, "
            f"WindowSize: {self.window_size}]"
        )
