"""Exporters: metrics files (JSON / Prometheus text) and trace JSONL.

The registry is pull-based — nothing in the serving stack pushes to a
collector; exporters serialise a snapshot when somebody asks (a CI
artifact step, the ``--metrics-out`` flag on the serving driver, a test).
``parse_prometheus`` exists so the text format is round-trippable and
therefore testable, not as a scraping client.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Optional

from repro_torch.obs import metrics as _metrics

__all__ = ["write_metrics", "parse_prometheus"]

#: One exposition line: name, optional {label="v",...} block, value.
_SAMPLE_RE = re.compile(
    r'^([A-Za-z_:][\w:]*)(\{[^}]*\})?\s+(\S+)\s*$')
_LABEL_RE = re.compile(r'([A-Za-z_][\w]*)="([^"]*)"')


def write_metrics(path: str,
                  registry: Optional[_metrics.MetricsRegistry] = None
                  ) -> str:
    """Write a registry snapshot to ``path``; format follows the extension
    (``.prom`` / ``.txt`` → Prometheus text, anything else → JSON).
    Returns the path."""
    reg = registry or _metrics.get_registry()
    if path.endswith((".prom", ".txt")):
        payload = reg.to_prometheus()
    else:
        payload = json.dumps(reg.snapshot(), indent=1, sort_keys=True,
                             default=str)
    with open(path, "w") as f:
        f.write(payload)
    return path


def parse_prometheus(text: str) -> Dict[str, Dict[str, float]]:
    """Parse exposition text back into ``{metric_name: {label_block: value}}``.

    Histogram series come back under their expanded sample names
    (``name_bucket`` / ``name_sum`` / ``name_count``) — exactly what
    :meth:`MetricsRegistry.to_prometheus` emitted, so equality against a
    re-parse is the round-trip test.
    """
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, labels, value = m.groups()
        # canonicalise the label block through the same formatter the
        # exporter uses (order preserved; parse validates syntax)
        block = ""
        if labels:
            pairs = _LABEL_RE.findall(labels)
            block = _metrics.label_str(tuple(k for k, _ in pairs),
                                       tuple(v for _, v in pairs))
        out.setdefault(name, {})[block] = float(value)
    return out
