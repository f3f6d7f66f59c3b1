"""The benchmark's own tests (CPU; the `gpu`-marked ones on the card)."""

import json

from portbench import harness


def full_spec() -> dict:
    """BENCHMARK.json with the entries of every cell under pending/
    merged in: the spec the tests drive the four-card path through."""
    spec = harness.load_spec()
    for path in sorted((harness.BENCH_DIR / "pending").glob("*.json")):
        extra = json.loads(path.read_text())
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            spec[key] = spec[key] + extra[key]
    return spec
