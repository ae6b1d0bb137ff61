"""PyTorch port vs the JAX reference: the deterministic data pipeline
(``repro_torch.data.pipeline``). ``make_batch`` is a pure function of
(config, step, host) and the port's copy must give the reference's bits
for every one of them; the prefetcher yields the stream in step order."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe

CONFIGS = [dict(vocab_size=50, seq_len=8, global_batch=4),
           dict(vocab_size=512, seq_len=128, global_batch=8, seed=3),
           dict(vocab_size=256000, seq_len=64, global_batch=6, seed=1,
                zipf_a=1.5, ngram_repeat=4)]


@pytest.mark.parametrize("kw", CONFIGS, ids=["tiny", "scaled", "gemma"])
@pytest.mark.parametrize("hosts", [1, 2])
def test_make_batch_is_the_reference_bit_for_bit(kw, hosts):
    tdc, jdc = tpipe.DataConfig(**kw), jpipe.DataConfig(**kw)
    for step in (0, 1, 7, 1000):
        for host in range(hosts):
            got = tpipe.make_batch(tdc, step, host, hosts)
            ref = jpipe.make_batch(jdc, step, host, hosts)
            assert set(got) == set(ref) == {"tokens", "labels"}
            for k in ref:
                assert got[k].dtype == ref[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], ref[k])


def test_hosts_get_disjoint_slices_of_one_stream():
    dc = tpipe.DataConfig(vocab_size=100, seq_len=16, global_batch=8)
    parts = [tpipe.make_batch(dc, 3, i, 4)["tokens"] for i in range(4)]
    assert all(p.shape == (2, 16) for p in parts)
    assert len({p.tobytes() for p in parts}) == 4
    again = tpipe.make_batch(dc, 3, 2, 4)["tokens"]
    np.testing.assert_array_equal(again, parts[2])


def test_prefetcher_yields_in_order():
    dc = tpipe.DataConfig(vocab_size=50, seq_len=8, global_batch=4)
    pf = tpipe.Prefetcher(dc, start_step=5, depth=2)
    got = [next(iter(pf)) for _ in range(3)]
    pf.stop()
    assert [s for s, _ in got] == [5, 6, 7]
    for s, batch in got:
        np.testing.assert_array_equal(batch["tokens"],
                                      tpipe.make_batch(dc, s)["tokens"])


def test_data_config_for_matches_reference():
    got = tpipe.data_config_for(get_config("gemma-2b"), 2048, 8, seed=4)
    ref = jpipe.data_config_for(jget_config("gemma-2b"), 2048, 8, seed=4)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
