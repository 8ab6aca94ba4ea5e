"""The offline driver's exact forcing assembly (``driver/io.py``:
``FileForcing``, ``_upload_steps``, ``ChunkPrefetcher``; ``driver/solar.py``)
against the JAX package's, bit for bit: the per-point work split over a
pool at any number of parts, the solar formula from cached latitude
terms, and the prefetcher's stack with the leaves that carry one value
a step uploaded as one value a step.

Nothing here compiles a JAX function: the JAX package's ``FileForcing``
and ``solar`` are numpy on the host.
"""

import datetime
import os
import sys
import threading

import numpy as np
import pytest
import torch

from noahmp_tpu.driver import io as jio
from noahmp_tpu.driver import solar as jsolar

from noahmp_tpu_torch.cases import conus_case
from noahmp_tpu_torch.driver import config as tconfig
from noahmp_tpu_torch.driver import io as tio
from noahmp_tpu_torch.driver import run as trun
from noahmp_tpu_torch.driver import solar as tsolar
from noahmp_tpu_torch.state import Forcing

N = 40003           # above the pool's threshold, not a multiple of 64
N_HELD = 200        # the case whose files hold co2air per point
D = datetime.datetime
# the leaves with one value a step: uploaded as (T,) vectors
ONE_A_STEP = ("co2air", "o2air", "foln", "julian", "yearlen")


def _case(tmp_path_factory, n, name):
    return conus_case(n, seed=5, days=1,
                      outdir=str(tmp_path_factory.mktemp(name)))


@pytest.fixture(scope="module")
def big_case(tmp_path_factory):
    """A day of the generated CONUS case at N points."""
    return _case(tmp_path_factory, N, "conus_pool")


@pytest.fixture(scope="module")
def held_case(tmp_path_factory):
    """A small case whose files hold ``co2air`` per point, ``foln`` as
    one value and no ``lon`` (the hour angle at longitude 0)."""
    d = _case(tmp_path_factory, N_HELD, "conus_held")
    cfg = tconfig.Config.from_namelist(os.path.join(d, "case.nml"))
    rng = np.random.default_rng(11)
    for name in sorted(os.listdir(cfg.indir)):
        path = os.path.join(cfg.indir, name)
        arrays = dict(tio.load_arrays(path))
        arrays["co2air"] = rng.uniform(30.0, 45.0, N_HELD).astype(np.float32)
        arrays["foln"] = np.asarray(2.5, np.float32)
        del arrays["lon"]
        tio.save_arrays(path, arrays)
    return d


def _providers(case_dir, **kw):
    cfg = tconfig.Config.from_namelist(os.path.join(case_dir, "case.nml"))
    t_static = tio.static_to_host(tio.load_domain(cfg.constfile,
                                                  device="cpu"))
    j_static = jio.load_domain(cfg.constfile)
    return (cfg, tio.FileForcing(cfg.indir, cfg.infreq, t_static, **kw),
            jio.FileForcing(cfg.indir, cfg.infreq, j_static, **kw))


def _assert_equal(label, got, want):
    for name in Forcing._fields:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype == np.float32, (label, name)
        assert a.shape == b.shape, (label, name)
        assert (a == b).all(), (label, name)


def _exact_stack(provider, when, steps, ts):
    fo = [provider(when + i * ts) for i in range(steps)]
    return {name: np.stack([np.asarray(getattr(f, name)) for f in fo])
            for name in Forcing._fields}


@pytest.mark.parametrize("n,parts,want", [
    (0, 4, []), (64, 4, [(0, 64)]), (100, 1, [(0, 100)]),
    (130, 2, [(0, 128), (128, 130)]),
    (40003, 7, [(k * 5760, min((k + 1) * 5760, 40003)) for k in range(7)]),
    (200, 3, [(0, 128), (128, 200)])])
def test_part_bounds_start_on_multiples_of_64(n, parts, want):
    bounds = tio.part_bounds(n, parts)
    assert bounds == want
    assert all(lo % tio.PART_ALIGN == 0 for lo, _hi in bounds)
    assert len(bounds) <= max(1, parts)


def test_pool_size_and_threshold():
    assert 1 <= tio.POOL_SIZE <= 2
    assert tio.POOL_SIZE == max(1, min(2, (os.cpu_count() or 1) // 2))
    assert N >= tio.POOL_MIN_POINTS > N_HELD


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 7])
def test_pooled_assembly_equal_at_every_step(big_case, parts):
    """A day at 900 s: every leaf of every step split over ``parts``
    slices == the one-part result == the JAX package's."""
    cfg, tff, jff = _providers(big_case)
    one = tio.FileForcing(cfg.indir, cfg.infreq, tff.static,
                          prefetch=False)
    for k in range(96):
        when = cfg.begdatetime + k * cfg.timestep
        got = tff.assemble(when, parts)
        _assert_equal((when, "one part"), got, one.assemble(when, 1))
        _assert_equal((when, "JAX"), got, jff(when))
        assert got.psfc is got.sfcprs
        for name in ONE_A_STEP:
            assert np.asarray(getattr(got, name)).strides == (0,), name


def test_call_uses_the_pool_above_the_threshold(big_case, monkeypatch):
    """``__call__`` splits over POOL_SIZE parts at N points."""
    cfg, tff, jff = _providers(big_case, prefetch=False)
    seen = []
    run_parts = tio._run_parts
    monkeypatch.setattr(tio, "_run_parts",
                        lambda fn, n, parts: (seen.append((n, parts)),
                                              run_parts(fn, n, parts))[1])
    when = cfg.begdatetime + 5 * cfg.timestep
    _assert_equal(when, tff(when), jff(when))
    assert seen == [(N, tio.POOL_SIZE)]


def test_a_failing_part_propagates(big_case, monkeypatch):
    """An exception in a part on the pool leaves ``assemble``, and the
    prefetcher's ``get`` raises it; no part falls back."""
    cfg, tff, _jff = _providers(big_case, prefetch=False)
    whole = tsolar.cos_zenith_from

    def fails_on_a_slice(sin_lat, *args):
        if sin_lat.shape[0] < N:
            raise ValueError("a part failed")
        return whole(sin_lat, *args)

    monkeypatch.setattr(tio.solar, "cos_zenith_from", fails_on_a_slice)
    when = cfg.begdatetime
    tff.assemble(when, 1)
    with pytest.raises(ValueError, match="a part failed"):
        tff.assemble(when, 7)
    monkeypatch.setattr(tio, "POOL_SIZE", 3)
    with pytest.raises(ValueError, match="a part failed"):
        tff(when)
    pre = tio.ChunkPrefetcher(tff, [(when, 2)], cfg.timestep, "cpu")
    try:
        with pytest.raises(ValueError, match="a part failed"):
            pre.get()
    finally:
        pre.close()
    assert not pre._t.is_alive()


@pytest.mark.parametrize("when", [
    D(2000, 1, 1, 0, 0), D(2000, 2, 29, 12, 0), D(2000, 12, 31, 23, 45),
    D(2001, 1, 1, 0, 0), D(2001, 12, 31, 23, 59, 30), D(2024, 7, 1, 6, 15),
    D(2100, 3, 1, 0, 0)],
    ids=lambda d: d.strftime("%Y%m%d%H%M%S"))
def test_cached_lat_terms_equal_cos_zenith(when):
    """The formula from cached float64 sin(lat), cos(lat) against the
    JAX package's ``cos_zenith``, bit for bit, at random points and at
    day and year boundaries (2000 is a leap year, 2100 is not)."""
    rng = np.random.default_rng(7)
    lat = rng.uniform(-np.pi / 2, np.pi / 2, 4099).astype(np.float32)
    lon = rng.uniform(-np.pi, np.pi, 4099).astype(np.float32)
    jd = tsolar.julian_day(when)
    yearlen = float(tsolar.year_length(when.year))
    assert jd == jsolar.julian_day(when) and jd < yearlen
    terms = tsolar.lat_terms(lat)
    for lon_now in (lon, 0.0):
        want = jsolar.cos_zenith(lat, lon_now, jd, yearlen)
        got = tsolar.cos_zenith_from(*terms, lon_now, jd, yearlen)
        assert got.dtype == want.dtype == np.float32
        assert (got == want).all()
        assert (tsolar.cos_zenith(lat, lon_now, jd, yearlen) == want).all()
        # 64-aligned slices of the cached terms give the same bits
        for lo, hi in tio.part_bounds(lat.shape[0], 5):
            part = tsolar.cos_zenith_from(
                terms[0][lo:hi], terms[1][lo:hi],
                lon_now if np.ndim(lon_now) == 0 else lon_now[lo:hi], jd,
                yearlen)
            assert (part == want[lo:hi]).all()


def _uploads(monkeypatch):
    """Patch ``io._upload`` to count the bytes handed to it."""
    sizes = []
    upload = tio._upload

    def counted(a, device):
        sizes.append(np.asarray(a).nbytes)
        return upload(a, device)

    monkeypatch.setattr(tio, "_upload", counted)
    return sizes


def _check_chunk(label, got, want, steps, n):
    ptrs = set()
    for name in Forcing._fields:
        leaf = getattr(got, name)
        assert leaf.dtype == torch.float32 and leaf.is_contiguous(), name
        assert tuple(leaf.shape) == (steps, n), name
        assert (leaf.numpy() == want[name]).all(), (label, name)
        ptrs.add(leaf.untyped_storage().data_ptr())
    assert len(ptrs) == len(Forcing._fields), label


@pytest.mark.parametrize("hours,cap", [(6, 8), (3, 5)])
def test_prefetcher_uploads_one_value_a_step(big_case, monkeypatch, hours,
                                             cap):
    """Every leaf == the stack of the provider's steps, contiguous, of
    its own storage; 9 per-point leaves and 5 values a step cross."""
    cfg, tff, _jff = _providers(big_case, prefetch=False)
    schedule = trun._chunk_schedule(
        cfg.begdatetime, cfg.begdatetime + datetime.timedelta(hours=hours),
        cfg.timestep, cfg.outfreq, tconfig.as_cadence(cfg.resfreq), cap)
    sizes = _uploads(monkeypatch)
    for when, steps in schedule:
        fo = [tff(when + i * cfg.timestep) for i in range(steps)]
        del sizes[:]
        got = tio._upload_steps(fo, "cpu")
        assert sum(sizes) == 9 * steps * N * 4 + 5 * steps * 4
        _check_chunk(when, got, _exact_stack(tff, when, steps, cfg.timestep),
                     steps, N)
    del sizes[:]
    pre = tio.ChunkPrefetcher(tff, schedule, cfg.timestep, "cpu")
    try:
        for when, steps in schedule:
            _check_chunk(when, pre.get(),
                         _exact_stack(tff, when, steps, cfg.timestep),
                         steps, N)
    finally:
        pre.close()
    assert not pre._t.is_alive()
    total = sum(steps for _when, steps in schedule)
    assert sum(sizes) == 9 * total * N * 4 + 5 * total * 4


@pytest.mark.parametrize("parts", [1, 3])
def test_files_that_hold_co2air_per_point(held_case, monkeypatch, parts):
    """``co2air`` from the files crosses per point, ``foln`` held as one
    value crosses as one value a step; both, and ``cosz`` without
    ``lon``, == the JAX package's."""
    cfg, tff, jff = _providers(held_case, prefetch=False)
    for k in (0, 3, 17, 50):
        when = cfg.begdatetime + k * cfg.timestep
        got = tff.assemble(when, parts)
        _assert_equal(when, got, jff(when))
        assert np.asarray(got.co2air).strides != (0,)
        assert (np.asarray(got.foln) == np.float32(2.5)).all()
    sizes = _uploads(monkeypatch)
    when, steps = cfg.begdatetime + datetime.timedelta(hours=2), 6
    got = tio._upload_steps(
        [tff(when + i * cfg.timestep) for i in range(steps)], "cpu")
    assert sum(sizes) == 10 * steps * N_HELD * 4 + 4 * steps * 4
    want = {name: np.stack([np.asarray(getattr(jff(when + i * cfg.timestep),
                                               name)) for i in range(steps)])
            for name in Forcing._fields}
    _check_chunk(when, got, want, steps, N_HELD)



def test_one_provider_from_many_threads(held_case):
    """Sixteen threads call one provider over six files (its caches
    evict) with a short switch interval: every result == the JAX
    package's, no thread fails or hangs."""
    cfg, tff, jff = _providers(held_case, prefetch=False)
    whens = [cfg.begdatetime + k * cfg.timestep for k in range(0, 22, 3)]
    want = {when: jff(when) for when in whens}
    errors = []

    def work(seed):
        try:
            for i in np.random.default_rng(seed).permutation(len(whens)):
                when = whens[i]
                _assert_equal(when, tff.assemble(when, 1 + seed % 3),
                              want[when])
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(seed,))
                   for seed in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
