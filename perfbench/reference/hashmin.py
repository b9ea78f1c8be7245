"""The plain reference of ``hashmin``: connected components, judged by the
partition of the vertices they give (the label of a component may be any
one id, so a program free to choose its representative is held to the
same answer).  Number compared: ``wrong_vertices``."""
from __future__ import annotations

from perfbench.reference import components


def expected(arcs: dict, params: dict):
    return components.min_labels(arcs["n"], arcs["src"], arcs["dst"])


def answer(state, slot, n_pad: int):
    return components.read_labels(state, slot, n_pad)


def compare(expected, answer) -> dict:
    return {"wrong_vertices": components.wrong_vertices(expected, answer)}
