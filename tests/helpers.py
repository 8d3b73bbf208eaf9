"""Shared test fixtures: a 1/8-width mini YOLOv3 through the same layer DSL.

Same topology as the full model (5 downsamples, routes at the two 8-block
stages, 3 heads) so every code path is exercised, but ~1% of the params --
keeps CPU jit compiles and step times fast.
"""

MINI_LAYERS = (
    (4, 3, 1),
    (8, 3, 2),
    ("B", 1),
    (16, 3, 2),
    ("B", 2),
    (32, 3, 2),
    ("B", 8),
    (64, 3, 2),
    ("B", 8),
    (128, 3, 2),
    ("B", 4),
    (64, 1, 1),
    (128, 3, 1),
    "S",
    (32, 1, 1),
    "U",
    (32, 1, 1),
    (64, 3, 1),
    "S",
    (16, 1, 1),
    "U",
    (16, 1, 1),
    (32, 3, 1),
    "S",
)


def mini_model(num_classes: int = 2, activation: str = "leaky_relu"):
    from yolo_for_turbines_tpu.config import ModelConfig
    from yolo_for_turbines_tpu.models.yolov3 import YOLOv3

    return YOLOv3(
        ModelConfig(
            num_classes=num_classes,
            activation=activation,
            layer_config=MINI_LAYERS,
        )
    )


# CSP variant of the mini model (("C", n) stages; same routes/heads).
MINI_CSP_LAYERS = tuple(
    ("C", e[1]) if isinstance(e, tuple) and e[0] == "B" else e
    for e in MINI_LAYERS
)


def concat_routes(model, x):
    """``model(x)`` with every folded conv on K5's route (the plain
    version off the card), twice: with the channel concats written in place,
    as on the card (``blocks.ChannelConcat``), and with ``torch.cat``
    (``blocks.concat_wins`` patched to refuse). Each as (outputs, bytes
    copied into concats, bytes K5 stored into them)."""
    import pytest
    import torch

    from yolo_for_turbines_tpu_torch.models import blocks
    from yolo_for_turbines_tpu_torch.utils import profiling

    def run(in_place: bool):
        with pytest.MonkeyPatch.context() as mp, torch.no_grad():
            mp.setattr(blocks, "epilogue_wins", lambda t, act, skip=None: True)
            if not in_place:
                mp.setattr(blocks, "concat_wins", lambda t, act, folded: False)
            mp.setattr(profiling, "concat_bytes", 0)
            mp.setattr(profiling, "concat_in_place_bytes", 0)
            out = model(x)
            return out, profiling.concat_bytes, profiling.concat_in_place_bytes

    return run(True), run(False)


def conv_inputs_channels_last(model, x):
    """Whether each ``FoldedConv`` of ``model`` read a channels_last input
    in ``model(x)``, in the order they ran."""
    import torch

    from yolo_for_turbines_tpu_torch.models.blocks import FoldedConv

    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].is_contiguous(memory_format=torch.channels_last)))
        for m in model.modules() if isinstance(m, FoldedConv)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen
