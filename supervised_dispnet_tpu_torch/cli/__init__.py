"""Command-line entry points."""

from __future__ import annotations

import argparse


def parse_args_or_raise(parser: argparse.ArgumentParser, argv: list[str] | None,
                        later_flags: frozenset[str],
                        where: str = "ROADMAP.md") -> argparse.Namespace:
    """Parse ``argv``; a JAX CLI flag in ``later_flags``, whose feature is not
    ported yet, raises ``NotImplementedError`` naming ``where``: it is never
    ignored. Other unknown arguments are the parser's usual error."""
    args, unknown = parser.parse_known_args(argv)
    for tok in unknown:
        flag = tok.split("=", 1)[0]
        if flag in later_flags:
            raise NotImplementedError(f"{flag} is not ported yet; see {where}")
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    return args
