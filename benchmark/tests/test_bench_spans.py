"""`benchlib.spans` on synthetic profiler records: device records put down
to the innermost span of their launching thread, with the fallback to the
span open on any thread; user-annotation records left out of the device
time, the busy time and the glue; the four groups adding up to the total;
idle gaps named by span; and a session without spans digested to exactly
`benchlib.profile.digest`'s result."""

import types

import pytest
from torch.autograd import DeviceType

from benchlib import profile, spans
from benchlib.result import Run, read_metric
from tools.span_split import by_span

MAIN, ENGINE = 1, 2


class Session:
    """Profiler events as `prof.events()` gives them: an opener spin and
    two marker spins around [100, 1000] us, then what a test adds."""

    def __init__(self):
        self.rows, self.next_id = [], 5000
        self.device("spin_kernel", 0, 300)        # an opener (300 us)
        self.device("spin_kernel", 90, 100)       # the first marker
        self.device("spin_kernel", 1000, 1010)    # the second marker

    def event(self, name, start, end, cuda=False, thread=MAIN, id=0,
              annotation=False):
        self.rows.append(types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=start, end=end),
            device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
            thread=thread, id=id, is_user_annotation=annotation))

    def device(self, name, start, end, id=0, annotation=False):
        self.event(name, start, end, cuda=True, id=id, annotation=annotation)

    def host(self, name, start, end, thread=MAIN):
        self.event(name, start, end, thread=thread)

    def launch(self, at, thread, kernel, start, end):
        """An operation at `at` on `thread` launching `kernel`, which runs
        on the device over [start, end]."""
        self.next_id += 1
        self.host("aten::op", at, at + 2, thread)
        self.event("cudaLaunchKernel", at + 0.5, at + 1.5, thread=thread,
                   id=self.next_id)
        self.device(kernel, start, end, id=self.next_id)

    def events(self):
        return list(self.rows)


def _step(s: Session):
    """One step: the forward with an LSTM and the loss on the main thread,
    the backward's LSTM on the engine's thread, then the update."""
    s.host("rnnt.train.step", 105, 900)
    s.host("rnnt.train.forward", 106, 300)
    s.host("rnnt.lstm", 110, 150)
    s.launch(120, MAIN, "lstm_fwd_mma_kernel", 130, 200)
    s.host("rnnt.loss", 160, 290)
    s.launch(170, MAIN, "plane_kernel", 200, 260)
    s.host("rnnt.train.backward", 310, 700)
    s.host("rnnt.lstm.bwd", 320, 400, thread=ENGINE)
    s.launch(330, ENGINE, "lstm_bwd_kernel", 330, 500)
    # the engine thread between its spans: the main thread's backward
    s.launch(450, ENGINE, "elementwise_kernel add", 500, 520)
    s.host("rnnt.train.update", 710, 890)
    s.launch(720, MAIN, "elementwise_kernel mul", 720, 740)
    # launched in no span at all
    s.launch(950, MAIN, "elementwise_kernel copy", 950, 960)


def _spans_of(d):
    return dict(zip((n for n, _, _ in d["device"]), d["device_span"]))


def test_records_go_to_the_innermost_span_of_their_launching_thread():
    s = Session()
    _step(s)
    d = spans.digest(s)
    assert _spans_of(d) == {
        "lstm_fwd_mma_kernel": "rnnt.lstm", "plane_kernel": "rnnt.loss",
        "lstm_bwd_kernel": "rnnt.lstm.bwd",
        "elementwise_kernel add": "rnnt.train.backward",
        "elementwise_kernel mul": "rnnt.train.update",
        "elementwise_kernel copy": None}
    assert ("rnnt.lstm.bwd", 320, 400, ENGINE) in d["spans"]


def test_the_launching_threads_span_wins_over_a_later_one_elsewhere():
    s = Session()
    _step(s)
    # the main thread opens a span inside the engine thread's LSTM span
    s.host("rnnt.parallel.all_reduce", 340, 380)
    s.launch(350, ENGINE, "lstm_bwd_kernel 2", 520, 530)
    s.launch(355, MAIN, "nccl_kernel", 530, 540)
    got = _spans_of(spans.digest(s))
    assert got["lstm_bwd_kernel 2"] == "rnnt.lstm.bwd"
    assert got["nccl_kernel"] == "rnnt.parallel.all_reduce"


def test_a_record_without_its_launch_call_has_no_span():
    s = Session()
    _step(s)
    s.device("orphan_kernel", 600, 610, id=99)
    assert _spans_of(spans.digest(s))["orphan_kernel"] is None


def _run(d, steps=1):
    return Run(m={}, traffic={"profile_steps": steps}, device={}, setup_s=0,
               attempted=0, failed=0, checks={}, profile=d)


def test_annotation_records_leave_device_busy_and_glue():
    s = Session()
    _step(s)
    # what record_function gives a range that launches kernels: a device
    # record over the gaps between them
    s.device("rnnt.train.step", 130, 960, annotation=True)
    old, new = profile.digest(s), spans.digest(s)
    assert "rnnt.train.step" in [n for n, _, _ in old["device"]]
    assert "rnnt.train.step" not in [n for n, _, _ in new["device"]]
    busy = (260 - 130) + (520 - 330) + (740 - 720) + (960 - 950)
    assert new["busy_s"] == pytest.approx(busy / 1e6)
    assert old["busy_s"] > new["busy_s"]
    glue_ms = (20 + 20 + 10) / 1e3
    assert read_metric("glue_ms_per_step.train", _run(new)) == \
        pytest.approx(glue_ms)
    assert read_metric("glue_ms_per_step.train", _run(old)) > glue_ms
    assert read_metric("idle_share.train", _run(old)) < read_metric(
        "idle_share.train", _run(new))


@pytest.mark.parametrize("steps", [1, 3])
def test_groups_add_up_to_every_record(steps):
    s = Session()
    _step(s)
    split = spans.group_ms_per_step(spans.digest(s), steps)
    total = sum(e - b for _, b, e in spans.digest(s)["device"]) / 1e3
    assert sum(split[g] for g in ("lstm", "loss", "optimizer", "other")) == \
        pytest.approx(total / steps)
    assert split["lstm"] == pytest.approx((70 + 170) / 1e3 / steps)
    assert split["loss"] == pytest.approx(60 / 1e3 / steps)
    assert split["optimizer"] == pytest.approx(20 / 1e3 / steps)
    assert split["other"] == pytest.approx((20 + 10) / 1e3 / steps)
    assert split["no_span"] == pytest.approx(10 / 1e3 / steps)


def test_tool_splits_by_span_and_the_glue_by_span():
    s = Session()
    _step(s)
    d = spans.digest(s)
    assert by_span(d, 2) == pytest.approx({
        "rnnt.lstm.bwd": 0.085, "rnnt.lstm": 0.035, "rnnt.loss": 0.03,
        "rnnt.train.backward": 0.01, "rnnt.train.update": 0.01,
        "none": 0.005})
    # the K4, K5 and K6 records are not glue
    assert by_span(d, 2, glue=True) == pytest.approx({
        "rnnt.train.backward": 0.01, "rnnt.train.update": 0.01,
        "none": 0.005})


def test_no_split_without_spans_in_the_digest():
    s = Session()
    s.launch(120, MAIN, "k", 130, 200)
    assert spans.group_ms_per_step(profile.digest(s), 1) is None
    assert spans.group_ms_per_step(None, 1) is None


def test_idle_gaps_carry_the_span():
    s = Session()
    _step(s)
    gaps = dict(spans.digest(s)["breakdown"]["idle_gaps"])
    # [100, 130]: in the LSTM span, with no host operation at 115
    assert gaps["rnnt.lstm"] == pytest.approx(30 / 1e6)
    # the other gaps' middles: 295 in the forward, 620 in the backward,
    # 845 in the update; 980 after the step, in no span
    assert set(gaps) == {"rnnt.lstm", "rnnt.train.forward",
                         "rnnt.train.backward", "rnnt.train.update",
                         "no host operation recorded"}
    s.host("aten::sum", 840, 850)
    gaps = dict(spans.digest(s)["breakdown"]["idle_gaps"])
    assert gaps["rnnt.train.update > aten::sum"] == pytest.approx(210 / 1e6)


def test_without_spans_the_digest_is_the_benchmarks():
    s = Session()
    for k in range(12):
        t = 110 + 70 * k
        s.host("aten::outer", t - 5, t + 40)
        s.launch(t, MAIN if k % 2 else ENGINE, f"kernel {k % 3}", t + 3,
                 t + 25 + k)
    s.host("cudaStreamSynchronize", 960, 990)
    assert spans.digest(s) == {**profile.digest(s),
                               "device_span": [None] * 12, "spans": []}


def test_no_markers_no_digest():
    s = Session()
    s.rows = [r for r in s.rows if r.time_range.end - r.time_range.start
              > 50]
    assert spans.digest(s) is None and profile.digest(s) is None
