"""A cell cut to a size the CPU runs in a second: the published shape of
EVA-CLIP-g's block at 2 layers, width 128, 4 heads of 32, 28 px frames,
batches of 8, videos of 5-30 s."""

import copy

from portbench import registry

TINY = dict(image_size=28, layers=2, width=128, head_width=32,
            mlp_ratio=4.0, embed_dim=32)
SEED = 2 ** 31 + 17  # larger than 32 signed bits hold


def tiny_cell(name: str, tolerance: float = 0.05,
              limit: float = 0.1) -> registry.Cell:
    cell = copy.deepcopy(registry.cell(name, registry.benchmark()))
    cell.config.update(TINY)
    chk = cell.config["check"]
    chk["frames"] = 16
    chk["frame_tolerance"] = tolerance
    chk["limits"]["excess_gap"] = limit
    cell.traffic["batch"] = 8
    cell.traffic["frame_pool"] = 16
    cell.traffic["length_s"].update(low=5, high=30)
    return cell
