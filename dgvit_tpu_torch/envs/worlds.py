"""World presets for the kinematic env — the RRC training arena plus an
unseen-layout generalization world.

The reference evaluates generalization by swapping gzserver's world file to
`world/hospital.world` (README.md:43-51) — the AWS RoboMaker hospital: a
central nurses station, elevator bays at the top wall, and bed/curtain bays
along both side walls. `HOSPITAL` approximates that floor plan with axis-
aligned boxes at a scale comparable to the RRC arena (goal distances < 15 m,
env_lab.py:296 normalization), so a policy trained on RRC can be evaluated on
a layout it never saw, Gazebo-free.

Boxes are (x0, x1, y0, y1); arena is (xmin, xmax, ymin, ymax) outer walls.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

Box = Tuple[float, float, float, float]


@dataclasses.dataclass(frozen=True)
class WorldPreset:
    name: str
    boxes: Tuple[Box, ...]
    arena: Tuple[float, float, float, float]


# Training arena: obstacle boxes of utils.check_pos (utils.py:78-86) inside
# the RRC outer walls — identical to the round-1 kinematic constants.
RRC = WorldPreset(
    name="rrc",
    boxes=(
        (3.6, 5.5, -3.5, 4.0), (-4.5, 4.0, -3.5, -1.8), (-3.5, 3.3, -1.6, 2.5),
        (-5.0, -4.0, -3.5, 0.3), (-5.5, -4.0, 2.0, 4.0),
        (-4.1, 0.1, 3.0, 4.0), (2.2, 3.8, 2.5, 4.0), (0.0, 2.3, 2.5, 4.0),
    ),
    arena=(-5.5, 5.5, -3.6, 4.1),
)

# Unseen generalization world (hospital.world floor plan, scaled ~1:2):
# nurses station island at center, elevator block on the top wall, patient
# bays (beds + curtains) along both side walls, a supply cart mid-corridor.
HOSPITAL = WorldPreset(
    name="hospital",
    boxes=(
        (-1.6, 1.6, 0.2, 2.2),      # nurses station island (pose 0, 1.5)
        (-2.2, 2.2, 8.6, 10.0),     # elevator portals block (y ~ 19 scaled)
        (-12.0, -10.2, -8.0, -5.6),  # patient bay SW (curtain row x ~ -11)
        (-12.0, -10.2, -4.4, -2.0),  # patient bay W
        (10.2, 12.0, -8.0, -5.6),   # patient bay SE (curtain row x ~ 11)
        (10.2, 12.0, -4.4, -2.0),   # patient bay E
        (-12.0, -10.4, 3.0, 5.4),   # exam room W
        (10.4, 12.0, 3.0, 5.4),     # exam room E
        (-5.6, -4.2, -5.2, -3.8),   # supply cart, lower corridor
        (4.2, 5.6, 4.6, 6.0),       # wheelchair stand, upper corridor
    ),
    arena=(-12.0, 12.0, -9.0, 10.0),
)

_PRESETS = {w.name: w for w in (RRC, HOSPITAL)}


def random_world(seed: int, n_boxes: int = 8,
                 arena: Tuple[float, float, float, float] = RRC.arena,
                 size_range: Tuple[float, float] = (0.6, 2.8),
                 name: str = None) -> WorldPreset:
    """Procedurally-generated obstacle layout in an RRC-sized arena —
    domain randomization for the transfer experiments (BENCH.md round 4:
    'transfer is world-diversity bound'). Boxes are uniform random
    axis-aligned rectangles; overlaps are allowed (they just merge into
    bigger obstacles), and spawn/goal validity is the record sampler's job
    (kinematic.default_records rejection-samples free, cleared positions).
    Deterministic in `seed`. Note: connectivity is not checked — a rare
    unreachable start/goal pair costs one timed-out episode, which the
    training loop already absorbs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ax0, ax1, ay0, ay1 = arena
    boxes = []
    for _ in range(n_boxes):
        w = float(rng.uniform(*size_range))
        h = float(rng.uniform(*size_range))
        cx = float(rng.uniform(ax0 + 0.5 + w / 2, ax1 - 0.5 - w / 2))
        cy = float(rng.uniform(ay0 + 0.5 + h / 2, ay1 - 0.5 - h / 2))
        boxes.append((cx - w / 2, cx + w / 2, cy - h / 2, cy + h / 2))
    return WorldPreset(name=name or f"rand{seed}", boxes=tuple(boxes),
                       arena=arena)


def random_ensemble(spec: str, seed: int = 0):
    """Parse a procedural-ensemble spec into K WorldPresets (the vectorized
    env's domain-randomization input):

      rand<K>   — K layouts in the RRC-sized arena (the round-4 baseline).
      randh<K>  — K layouts in the HOSPITAL-sized arena (24x19 m): more,
                  larger boxes at comparable fill so long-range behavior
                  gets gradients.
      randm<K>  — mixed SCALES: even members RRC-sized, odd members
                  hospital-sized. Motivated by the measured drr_rand32
                  asymmetry (82% zero-shot RRC / 0% hospital, BENCH.md
                  round 4): same-scale diversity buys within-class
                  transfer only; cross-scale transfer needs arena-scale
                  diversity in training.

    Deterministic in (spec, seed); member i draws from seed 1000*seed+i,
    so rand<K> members are unchanged from the pre-randm behavior."""
    for prefix, variants in (("randm", "m"), ("randh", "h"), ("rand", "")):
        if spec.startswith(prefix):
            k = int(spec[len(prefix):] or "8")
            break
    else:
        raise ValueError(f"not a rand spec: {spec!r}")

    def member(i):
        s = 1000 * seed + i
        big = variants == "h" or (variants == "m" and i % 2 == 1)
        if big:
            return random_world(s, n_boxes=20, arena=HOSPITAL.arena,
                                size_range=(0.8, 3.6),
                                name=f"{spec}_{i}")
        return random_world(s, name=f"{spec}_{i}" if variants else None)

    return [member(i) for i in range(k)]


def get_world(name: str) -> WorldPreset:
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown world {name!r}; available: {sorted(_PRESETS)} "
            "(vectorized-env ensembles also accept 'rand<K>')") from None
