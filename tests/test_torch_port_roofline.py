"""The port's measured-peak harness (``omnihd_scenes_tpu_torch/tools/
roofline.py``) against the JAX package's (``omnihd_scenes_tpu/tools/
roofline.py``), on the CPU:

* ``fit_peak`` gives JAX's dict on the same synthetic timings: the
  recovered rate and overhead, and the non-monotonic error;
* ``chained_time`` feeds each call's scalar to the next call as its carry;
* ``wait_for`` (``--wait-for``) blocks while another holder locks the file;
* ``main(['--small', '--iters', '2', '--device', 'cpu'])`` runs the
  probes here and prints the card line, then JAX's six probe names in
  JAX's order;
* with both harnesses' timers made to return the same seconds, each
  probe's record (name, ms and ``tflops``, i.e. its flop count) equals
  JAX's, and each flop count is JAX's formula.  JAX's own probes are
  never timed here (their jitted loops take minutes on one core).
"""

import fcntl
import json
import threading

import pytest
import torch

from omnihd_scenes_tpu.tools import roofline as jax_roofline
from omnihd_scenes_tpu_torch.tools import roofline

torch.set_num_threads(1)
N1, N2 = 4096, 8192


def _timings(rate, overhead, n1=N1, n2=N2):
    return ({'ms': (2 * n1 ** 3 / rate + overhead) * 1e3},
            {'ms': (2 * n2 ** 3 / rate + overhead) * 1e3})


@pytest.mark.parametrize('rate, overhead', [
    (100e12, 5e-4), (989e12, 2e-5), (650.5e12, 1.3e-4), (1e9, 0.0)])
def test_fit_peak_equals_jax(rate, overhead):
    r1, r2 = _timings(rate, overhead)
    got = roofline.fit_peak(r1, r2, N1, N2)
    assert got == jax_roofline.fit_peak(r1, r2, N1, N2)
    assert got['practical_peak_tflops'] == pytest.approx(rate / 1e12,
                                                         abs=0.06)
    assert got['per_iter_overhead_ms'] == pytest.approx(overhead * 1e3,
                                                        abs=1e-3)


@pytest.mark.parametrize('t1, t2', [(2.0, 1.0), (2.0, 2.0), (2.0, 2.09),
                                    (0.0, 0.0)])
def test_fit_peak_flags_non_monotonic_timings_as_jax(t1, t2):
    r1, r2 = {'ms': t1}, {'ms': t2}
    got = roofline.fit_peak(r1, r2, 256, 512)
    assert got == jax_roofline.fit_peak(r1, r2, 256, 512)
    assert got['practical_peak_tflops'] is None
    assert got['error'].startswith('non-monotonic timings')


def test_chained_time_feeds_each_output_to_the_next_call():
    seen = []

    def fn(c, x):
        seen.append(float(c))
        return c + x

    seconds = roofline.chained_time(fn, (torch.tensor(1.0),), 4, 'cpu')
    assert seconds > 0
    # One warm-up and three timed runs, each from a zero carry.
    assert seen == [0.0, 1.0, 2.0, 3.0] * (1 + roofline.TIMED_RUNS)


def _records(out):
    lines = out.strip().splitlines()
    return lines[0], [json.loads(line) for line in lines[1:]]


def _jax_records(monkeypatch, capsys, seconds=None):
    """JAX's ``main(['--small'])`` records, its timer made to return
    ``seconds`` (or a rising time a call, so that the fit succeeds)."""
    times = iter(range(1, 100))
    monkeypatch.setattr(
        jax_roofline, 'chained_time', lambda fn, args, iters: (
            seconds if seconds is not None else next(times) * 1e-3))
    jax_roofline.main(['--small', '--iters', '2'])
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def test_small_main_prints_jax_probe_names_in_order(monkeypatch, capsys):
    want = [r['probe'] for r in _jax_records(monkeypatch, capsys)]
    roofline.main(['--small', '--iters', '2', '--device', 'cpu'])
    card, records = _records(capsys.readouterr().out)
    assert card.startswith('cpu')
    assert [r['probe'] for r in records] == want == [
        'dot_256_bfloat16', 'dot_512_bfloat16', 'fitted',
        'conv3x3_256to256_16x24_bfloat16', 'conv3x3_768to256_16x24_bfloat16',
        'dot_256_int8']
    for r in records:
        if 'ms' in r:
            assert r['ms'] > 0 and r['tflops'] > 0


def test_small_records_equal_jax_at_equal_times(monkeypatch, capsys):
    t = 2.5e-4
    want = _jax_records(monkeypatch, capsys, seconds=t)
    monkeypatch.setattr(roofline, 'chained_time',
                        lambda fn, args, iters, device: t)
    roofline.main(['--small', '--iters', '2', '--device', 'cpu'])
    _, got = _records(capsys.readouterr().out)
    assert got == want
    assert got[2]['practical_peak_tflops'] is None     # equal times
    flops = [2.0 * 256 ** 3, 2.0 * 512 ** 3, None,
             2.0 * 2 * 16 * 24 * 9 * 256 * 256,
             2.0 * 2 * 16 * 24 * 9 * 768 * 256, 2.0 * 256 ** 3]
    for r, f in zip(got, flops):
        if f is not None:
            assert r['tflops'] == round(f / t / 1e12, 3)


def test_wait_for_blocks_while_the_lock_is_held(tmp_path):
    path = tmp_path / 'card.lock'
    path.write_text('')
    with open(path) as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        waiter = threading.Thread(target=roofline.wait_for, args=(str(path),))
        waiter.start()
        waiter.join(0.3)
        assert waiter.is_alive()
        fcntl.flock(held, fcntl.LOCK_UN)
    waiter.join(10)
    assert not waiter.is_alive()


def test_cuda_without_a_card_exits():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(SystemExit):
        roofline.main(['--small'])
