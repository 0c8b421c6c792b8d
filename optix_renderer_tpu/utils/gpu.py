"""The card a run is on: refuse anything but GPUs, and read each card's name
and power limit from nvidia-smi, so that every timing can name both."""

from __future__ import annotations

import subprocess

SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")


def require_gpu(devices, count: int = 1) -> None:
    """Refuse to run anywhere but on `count` or more GPUs."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(f"needs a GPU, JAX found platform '{plat}'")
    if len(devices) < count:
        raise SystemExit(f"needs {count} GPUs, JAX found {len(devices)}")


def parse_smi(text: str) -> list[tuple[str, str]]:
    """Output of the `SMI_QUERY` command → [(name, power limit)] per card."""
    cards = []
    for line in text.strip().splitlines():
        name, _, limit = line.rpartition(",")
        if not name:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def query_cards() -> tuple[str, list[tuple[str, str]]]:
    """Run `SMI_QUERY`; returns its text and the parsed cards."""
    text = subprocess.run(
        SMI_QUERY, capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()
    return text, parse_smi(text)
