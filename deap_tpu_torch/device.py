"""Where the port runs, and what card it runs on.

Entry points run on CUDA unless the caller passes ``device="cpu"``. With
no card present and the CPU not asked for, they raise: nothing falls back
to the CPU quietly.
"""

from __future__ import annotations

import subprocess
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev


def make_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A seeded ``torch.Generator`` on the resolved device — the port's
    counterpart of ``jax.random.key(seed)``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def check_generator(generator: torch.Generator,
                    device: torch.device) -> None:
    """Draws land on the generator's device, so it must be ``device``."""
    if generator.device.type != device.type:
        raise ValueError(
            f"generator lives on {generator.device}, the run on {device}")


def gpu_facts() -> str:
    """The cards' names and power limits as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them;
    printed beside every number taken on a card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip()
