"""K5-hw's phase clock (csrc/evolve_packed.cu under -DDTT_K5_PHASES) and
the names ``port_profile.py --kernel-times`` gives its totals agree.

The clock runs only on the card; these checks read the source, so a phase
added to the kernel without a name (or the reverse) fails here."""

import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = ROOT / "deap_tpu_torch" / "csrc" / "evolve_packed.cu"


def _kernel_phases():
    text = SOURCE.read_text()
    count = int(re.search(r"constexpr int kPhases = (\d+);", text).group(1))
    marks = [int(m) for m in re.findall(r"K5_MARK\((\d+)\);", text)]
    return count, marks


def test_every_phase_of_the_clock_has_a_name():
    import port_profile
    count, _ = _kernel_phases()
    assert len(port_profile.K5_PHASES) == count
    assert len(set(port_profile.K5_PHASES)) == count


def test_the_kernel_marks_each_phase_once_in_order():
    count, marks = _kernel_phases()
    assert marks == list(range(count))
    # the default build has no clock: the marks expand to nothing and the
    # read-out entry exists only under the macro
    text = SOURCE.read_text()
    entry = text.index('extern "C" int evolve_packed_hw_phases')
    assert text.rfind("#ifdef DTT_K5_PHASES", 0, entry) > text.rfind(
        "#endif", 0, entry)
