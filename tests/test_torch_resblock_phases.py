"""Torch port: the arithmetic of tools/resblock_phases.py (the phase stamps
themselves exist only in an instrumented build on the card)."""

import ctypes

import numpy as np
import pytest

from yolo_for_turbines_tpu_torch.tools import resblock_phases as rp


class _StampedLib:
    """Stands in for the instrumented library: hands out fixed stamps."""

    def __init__(self, stamps):
        self.stamps = np.ascontiguousarray(stamps, np.int64)

    def resblock_phases(self, ptr, ctas):
        ctypes.memmove(ptr, self.stamps.ctypes.data, self.stamps[:ctas].nbytes)
        return 0


def test_phase_summary_from_stamps():
    # B=2 at 26x26: 7 row tiles x 2 channel halves x 2 images = 28 CTAs. At a
    # 2 GHz SM clock each phase k lasts (k + 1) us; CTA i starts at i us.
    n = len(rp.PHASES)
    ctas = 28
    step_cycles = np.cumsum([0] + [2000 * (k + 1) for k in range(n - 1)])
    stamps = np.zeros((ctas, n + 2), np.int64)
    for i in range(ctas):
        stamps[i, :n] = 10 ** 6 + 7 * i + step_cycles  # any clock origin
        stamps[i, n] = 1000 * i                       # global timer, ns
        stamps[i, n + 1] = 1000 * i + step_cycles[-1] // 2
    got = rp.phase_summary(_StampedLib(stamps), batch=2, hw=26, sms=132)
    assert got["ctas"] == ctas
    assert got["sm_clock_ghz"] == pytest.approx(2.0)
    assert list(got["phases_us"]) == list(rp.PHASES[1:])
    np.testing.assert_allclose(list(got["phases_us"].values()), np.arange(1, n), rtol=1e-9)
    cta_us = n * (n - 1) / 2
    assert got["cta_us"] == pytest.approx(cta_us)
    assert sum(got["phase_share"].values()) == pytest.approx(1.0)
    span_us = (ctas - 1) + cta_us
    assert got["span_us"] == pytest.approx(span_us)
    assert got["sm_busy_share"] == pytest.approx(ctas * cta_us / (132 * span_us))


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(rp.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        rp.main([])


def test_phase_summary_reads_k4_stamps():
    # K4's instrumented build has its own stamp reader; the tiling, and so
    # the CTA count, is K2's
    n = len(rp.PHASES)
    stamps = np.zeros((14, n + 2), np.int64)
    stamps[:, :n] = 1800 * np.arange(n)
    stamps[:, n + 1] = 1000 * (n - 1)

    class Lib:
        def resblock_int8_phases(self, ptr, ctas):
            return _StampedLib(stamps).resblock_phases(ptr, ctas)

    got = rp.phase_summary(Lib(), batch=1, hw=26, sms=132, kernel="k4")
    assert got["ctas"] == 14
    assert got["sm_clock_ghz"] == pytest.approx(1.8)
    assert got["cta_us"] == pytest.approx(n - 1)


@pytest.mark.parametrize("kernel", sorted(rp.KERNELS))
def test_phase_sources_exist_and_carry_the_stamps(kernel):
    source, launch, reader = rp.KERNELS[kernel]
    text = (rp.kernels.CSRC_DIR / source).read_text()
    assert "#ifdef RESBLOCK_PHASES" in text
    assert f'extern "C" int {launch}(' in text and f'extern "C" int {reader}(' in text
    assert launch in rp.kernels._SIGNATURES
    assert f"kPhases = {len(rp.PHASES)};" in text
