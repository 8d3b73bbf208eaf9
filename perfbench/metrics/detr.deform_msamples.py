"""Millions of bilinear samples that RT-DETR's deformable attention takes
per batch: the program's counter ``utils/profiling.py::deform_samples``
(every sample of the process, from its start; B x queries x heads x levels
x points per decoder layer) over the forwards the run made: the warm-up's
(``warm_iterations`` x ``pool``), the quiet window's and the traced
window's. None where the program has no such counter or the run was not
traced."""


def read(run):
    from yolo_for_turbines_tpu_torch.utils import profiling

    counted = getattr(profiling, "deform_samples", None)
    if counted is None or run.trace is None:
        return None
    forwards = (run.mix["warm_iterations"] * run.mix["pool"] + len(run.records)
                + run.trace.count("perfbench.call"))
    return counted / forwards / 1e6
