"""``mfu.<kind>``: model FLOPs of the window's completed work items (the
family's count from the configuration's sizes: a train step's forward
and backward, a prompt batch's forward, a decode step's matmuls and
attention over each sequence's live rows), over the window's time, as a
share of the card's bf16 peak."""

from portbench.peaks import BF16_FLOPS


def read(cell):
    if not cell.stats.get("flops") or not cell.stats.get("seconds"):
        return None
    return 100.0 * cell.stats["flops"] / cell.stats["seconds"] / BF16_FLOPS
