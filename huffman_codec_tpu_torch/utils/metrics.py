"""Structured codec metrics — bpc / throughput / chunk accounting.

The reference publishes bpc + wall time per file (readme.md:71-92); this is
the same accounting as a reusable record, JSON-serializable for benches and
logs.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field


@dataclass
class CodecMetrics:
    input_bytes: int = 0
    output_bytes: int = 0
    encode_s: float = 0.0
    decode_s: float = 0.0
    n_chunks: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def bpc(self) -> float:
        """Compressed bits per input byte (readme.md:85)."""
        return 8.0 * self.output_bytes / self.input_bytes if self.input_bytes else 0.0

    @property
    def encode_mbps(self) -> float:
        return self.input_bytes / self.encode_s / 1e6 if self.encode_s else 0.0

    @property
    def decode_mbps(self) -> float:
        return self.input_bytes / self.decode_s / 1e6 if self.decode_s else 0.0

    def to_json(self) -> str:
        d = asdict(self)
        d.update(bpc=round(self.bpc, 4), encode_mbps=round(self.encode_mbps, 3),
                 decode_mbps=round(self.decode_mbps, 3))
        return json.dumps(d)
