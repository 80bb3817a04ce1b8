"""A tiny cell for CPU tests: the real cell's files at small widths, four
lanes of 32-byte pieces."""

import torch

from portbench.harness.spec import Cell

TINY = dict(block_size=32, seg_size=16, tbits=12, mbits=14, pbits=14,
            ibits=12, lstm_hidden=32, dmc_nodes=4096, max_batch=4)


def tiny_cell(name="cli.mixed.b64"):
    torch.set_num_threads(1)
    cell = Cell(name)
    cell.config = dict(cell.config, **TINY)
    cell.traffic = dict(cell.traffic, lanes=4, piece_bytes=32)
    return cell
