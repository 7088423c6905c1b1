"""Shared helpers for the CLI examples."""

from __future__ import annotations

import argparse

from ..ff.field import resolve_device


def say(msg: str) -> None:
    print(msg, flush=True)


def fr_hex(v: int) -> str:
    return f"0x{v:064x}"


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    """--device, resolved as it is parsed: the default "cuda" raises without
    a card, as every entry point of the port does."""
    parser.add_argument(
        "--device", default="cuda", type=resolve_device,
        help="where the engine and the trees run (default cuda; cpu without a card)",
    )
