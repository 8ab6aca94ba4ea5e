"""The port's offline-driver I/O against the JAX package's, on the same
inputs: namelist and cadence, solar geometry, the chunk schedule, the
NetCDF writer's bytes, restarts across the two packages, the file
forcing and its compact form, the generated CONUS case, shard merging
and geogrid ingestion.

Nothing here compiles a JAX function: every JAX function called is
numpy on the host (the JAX package's ``driver/io.py`` imports
``jax.numpy`` but its providers and writers do not use it).
"""

import datetime
import filecmp
import os
import sys

import numpy as np
import pytest
import torch

from noahmp_tpu.driver import config as jconfig
from noahmp_tpu.driver import io as jio
from noahmp_tpu.driver import netcdf as jnetcdf
from noahmp_tpu.driver import run as jrun
from noahmp_tpu.driver import solar as jsolar
from noahmp_tpu import state as jstate

from noahmp_tpu_torch.cases import conus_case
from noahmp_tpu_torch.convert import tree_on_device, tree_to_numpy
from noahmp_tpu_torch.driver import config as tconfig
from noahmp_tpu_torch.driver import geo as tgeo
from noahmp_tpu_torch.driver import io as tio
from noahmp_tpu_torch.driver import merge as tmerge
from noahmp_tpu_torch.driver import netcdf as tnetcdf
from noahmp_tpu_torch.driver import run as trun
from noahmp_tpu_torch.driver import solar as tsolar
from noahmp_tpu_torch.state import Forcing, State, init_state, init_static

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = os.path.join(REPO, "examples", "case.nml")
D = datetime.datetime


def _make_case():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import make_case
    return make_case


@pytest.fixture(scope="module")
def forcing_case(tmp_path_factory):
    """A day of ``make_case.conus(24, seed=3)`` files, as
    ``test_compact_forcing.py`` uses."""
    d = str(tmp_path_factory.mktemp("conus24"))
    _make_case().conus(24, seed=3, days=1, outdir=d, fmt="nc")
    return d


# ---------------------------------------------------------------------
# namelist, cadence, solar geometry, schedule


def test_namelist_and_config_equal():
    assert tconfig.read_namelist(CASE) == jconfig.read_namelist(CASE)
    j = jconfig.Config.from_namelist(CASE)
    t = tconfig.Config.from_namelist(CASE)
    for name in ("constfile", "initfile", "resfile", "indir", "infreq",
                 "outdir", "resdir", "begdatetime", "enddatetime",
                 "timestep", "veg_scheme", "soil_scheme", "restart",
                 "nsteps", "dt"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("outfreq", "resfreq"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a.seconds, a.months, a.years) == (b.seconds, b.months,
                                                  b.years), name
    assert tuple(t.options) == tuple(j.options)
    assert t.options._fields == j.options._fields
    assert tconfig._ANCHOR == jconfig._ANCHOR


def test_missing_field_raises_alike(tmp_path):
    bad = tmp_path / "bad.nml"
    bad.write_text("&NOAHMP_OFFLINE\n start_year = 2000\n/\n")
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="missing mandatory"):
            mod.Config.from_namelist(str(bad))


# the calendar cases of tests/test_driver.py (cadence, due, next_due)
DUE_CASES = [
    ("1 month", D(2000, 2, 1)), ("1 month", D(2000, 3, 1)),
    ("1 month", D(2001, 3, 1)), ("1 month", D(2000, 1, 31)),
    ("1 month", D(2000, 3, 2)), ("1 month", D(2000, 3, 1, 0, 15)),
    ("1 month", D(2000, 2, 29)), ("3 months", D(2000, 1, 1)),
    ("3 months", D(2000, 4, 1)), ("3 months", D(2000, 2, 1)),
    ("1 year", D(2001, 1, 1)), ("1 year", D(2001, 1, 2)),
    ("1 year", D(2001, 7, 1)), ("3 hour", D(2000, 6, 5, 0)),
    ("3 hour", D(2000, 6, 5, 3)), ("3 hour", D(2000, 6, 5, 21)),
    ("3 hour", D(2000, 6, 5, 4)), ("3 hour", D(2000, 6, 5, 3, 15)),
    ("1 day", D(2000, 7, 2)), ("15 minutes", D(2000, 7, 1, 0, 45)),
]


@pytest.mark.parametrize("spec,when", DUE_CASES)
def test_cadence_due_and_next_due_equal(spec, when):
    t, j = tconfig.parse_cadence(spec), jconfig.parse_cadence(spec)
    assert t.due(when) == j.due(when)
    assert t.next_due(when) == j.next_due(when)
    assert t.total_seconds() == j.total_seconds()


@pytest.mark.parametrize("cad,when", [
    (dict(seconds=3 * 3600.0), D(2000, 2, 28, 22, 15)),
    (dict(seconds=3 * 3600.0), D(2000, 1, 1)),
    (dict(months=1), D(2000, 2, 28, 22, 15)),
    (dict(months=1), D(2000, 3, 1)),
    (dict(months=2), D(2000, 2, 15)),
    (dict(years=1), D(2000, 2, 28, 22, 15)),
])
def test_cadence_objects_equal(cad, when):
    t, j = tconfig.Cadence(**cad), jconfig.Cadence(**cad)
    assert t.next_due(when) == j.next_due(when)
    assert t.due(t.next_due(when)) and j.due(j.next_due(when))
    delta = datetime.timedelta(hours=1)
    assert tconfig.as_cadence(delta) == tconfig.Cadence(seconds=3600.0)
    assert tconfig.as_cadence(900) == tconfig.Cadence(seconds=900.0)


@pytest.mark.parametrize("spec", ["1 hour", "3 hour", "1 month", 900,
                                  "30 min", "2 days", "0.5 hours"])
def test_parse_frequency_equal(spec):
    assert tconfig.parse_frequency(spec) == jconfig.parse_frequency(spec)


def test_parse_frequency_refusals_alike():
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError):
            mod.parse_frequency("5 fortnights")
        with pytest.raises(ValueError):
            mod.parse_cadence("often")


def test_cos_zenith_julian_year_length_equal():
    rng = np.random.default_rng(0)
    lat = rng.uniform(-1.4, 1.4, 257).astype(np.float32)
    lon = rng.uniform(-3.1, 3.1, 257).astype(np.float32)
    for jd in (0.0, 80.5, 172.25, 181.9, 365.99):
        for yl in (365.0, 366.0):
            a = tsolar.cos_zenith(lat, lon, jd, yl)
            b = jsolar.cos_zenith(lat, lon, jd, yl)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    for when in (D(2000, 7, 1, 0, 15), D(2001, 12, 31, 23, 45),
                 D(2004, 2, 29, 12)):
        assert tsolar.julian_day(when) == jsolar.julian_day(when)
    for year in (1900, 2000, 2001, 2004, 2100):
        assert tsolar.year_length(year) == jsolar.year_length(year)


@pytest.mark.parametrize("begin,hours,out,res,cap", [
    (D(2000, 7, 1), 48, "3 hour", "1 day", 16),
    (D(2000, 7, 1), 6, "1 hour", "3 hour", 2 ** 21 // 32),
    (D(2000, 7, 1, 1, 45), 30, "3 hour", "1 day", 2),
    (D(2000, 1, 30, 22), 72, "1 month", "1 month", 64),
    (D(2000, 7, 1), 12, "3 hour", "1 day", 1),
    (D(2000, 12, 31, 20), 8, "2 hour", "1 year", 7),
])
def test_chunk_schedule_equal(begin, hours, out, res, cap):
    ts = datetime.timedelta(seconds=900)
    end = begin + datetime.timedelta(hours=hours)
    got = trun._chunk_schedule(begin, end, ts, tconfig.parse_cadence(out),
                               tconfig.parse_cadence(res), cap)
    want = jrun._chunk_schedule(begin, end, ts, jconfig.parse_cadence(out),
                                jconfig.parse_cadence(res), cap)
    assert got == want
    assert all(steps & (steps - 1) == 0 for _w, steps in got)


# ---------------------------------------------------------------------
# NetCDF bytes, restarts


def _arrays(n=7, seed=0):
    rng = np.random.default_rng(seed)
    return {"fsh": rng.normal(size=n).astype(np.float32),
            "nsnow": rng.integers(0, 3, n).astype(np.int32),
            "smc": rng.uniform(0.1, 0.4, (n, 4)).astype(np.float32),
            "stc": rng.uniform(260, 300, (n, 7)).astype(np.float32),
            "lat64": rng.uniform(0, 1, n),
            "_timestamp": np.asarray("2000-07-01T03:00:00")}


def test_write_classic_bytes_equal_and_cross_read(tmp_path):
    arrays = _arrays()
    pt, pj = str(tmp_path / "t.nc"), str(tmp_path / "j.nc")
    tnetcdf.write_classic(pt, arrays)
    jnetcdf.write_classic(pj, arrays)
    assert filecmp.cmp(pt, pj, shallow=False)
    for reader, path in ((tnetcdf, pj), (jnetcdf, pt)):
        back = reader.read_arrays(path)
        assert set(back) == set(arrays)
        stamp = np.asarray(back.pop("_timestamp")).ravel()[0]
        assert stamp in (b"2000-07-01T03:00:00", "2000-07-01T03:00:00")
        for k, v in back.items():
            np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    # a slice read through the byte-range reader
    for reader, path in ((tnetcdf, pj), (jnetcdf, pt)):
        sl = reader.read_classic_slice(path, "smc", 2, 5)
        np.testing.assert_array_equal(sl, arrays["smc"][2:5])


def test_save_arrays_npz_and_fallback(tmp_path):
    arrays = {k: v for k, v in _arrays().items() if k != "_timestamp"}
    p = str(tmp_path / "a.npz")
    tio.save_arrays(p, arrays)
    for mod in (tio, jio):
        back = mod.load_arrays(str(tmp_path / "a.nc"))   # .npz beside
        for k, v in arrays.items():
            np.testing.assert_array_equal(back[k], v)


def _port_state(n=6):
    st = init_state(n, device="cpu")
    return st._replace(tg=st.tg + torch.arange(n, dtype=torch.float32),
                       nsnow=torch.tensor([0, 1, 2, 3, 0, 1][:n],
                                          dtype=torch.int32),
                       smc=st.smc * 0.9)


@pytest.mark.parametrize("ext", [".nc", ".npz"])
def test_restart_loads_in_the_other_package(tmp_path, ext):
    when = D(2000, 7, 1, 3)
    state = _port_state()
    leaves = tree_to_numpy(state)
    pt = str(tmp_path / ("port_restart" + ext))
    pj = str(tmp_path / ("jax_restart" + ext))
    tio.save_restart(pt, state, when)
    jio.save_restart(pj, jstate.State(**leaves), when)
    if ext == ".nc":
        assert filecmp.cmp(pt, pj, shallow=False)
    j_state, j_when = jio.load_restart(pt)
    t_state, t_when = tio.load_restart(pj, device="cpu")
    assert j_when == t_when == when
    assert isinstance(t_state, State) and t_state.tg.device.type == "cpu"
    for name in State._fields:
        a, b = np.asarray(getattr(j_state, name)), leaves[name]
        c = getattr(t_state, name).numpy()
        assert a.dtype == b.dtype == c.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(c, b, err_msg=name)
    assert t_state.nsnow.dtype == torch.int32


def test_load_restart_rejects_corrupt_state(tmp_path):
    p = str(tmp_path / "restart.npz")
    state = _port_state(4)
    tio.save_restart(p, state, D(2000, 1, 5))
    tio.load_restart(p, device="cpu")
    tg = state.tg.clone()
    tg[1] = float("nan")
    tio.save_restart(p, state._replace(tg=tg), D(2000, 1, 5))
    with pytest.raises(ValueError, match="non-finite tg"):
        tio.load_restart(p, device="cpu")
    tio.save_restart(p, state._replace(
        nsnow=torch.tensor([0, 5, 0, 0], dtype=torch.int32)), D(2000, 1, 5))
    with pytest.raises(ValueError, match="snow layer count"):
        tio.load_restart(p, device="cpu")


def test_domain_and_init_load_like_jax(tmp_path):
    n = 3
    np.savez(tmp_path / "domain.npz", lat=np.full(n, 0.5, np.float32),
             lutyp=np.array([1, 7, 14], np.int32),
             sltyp=np.array([3, 6, 9], np.int32))
    np.savez(tmp_path / "init.npz", tg=np.full(n, 300.0, np.float32),
             smc=np.full((n, 4), 0.25, np.float32))
    t_static = tio.load_domain(str(tmp_path / "domain.nc"), device="cpu")
    j_static = jio.load_domain(str(tmp_path / "domain.nc"))
    for name, leaf in zip(t_static._fields, t_static):
        want = np.asarray(getattr(j_static, name))
        assert leaf.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(leaf.numpy(), want, err_msg=name)
    t_state = tio.load_init(str(tmp_path / "init.npz"), n, device="cpu")
    j_state = jio.load_init(str(tmp_path / "init.npz"), n)
    for name in State._fields:
        want = np.asarray(getattr(j_state, name))
        got = getattr(t_state, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert float(t_state.tg[0]) == 300.0
    np.testing.assert_array_equal(t_state.swc.numpy(), t_state.smc.numpy())


@pytest.mark.parametrize("field,bad", [("lutyp", 28), ("lutyp", 0),
                                       ("sltyp", 20), ("isc", 10),
                                       ("slptyp", 0), ("ist", 3)])
def test_validate_static_rejects_bad_indices(tmp_path, field, bad):
    n = 8
    d = dict(lat=np.full(n, 0.7, np.float32), lutyp=np.full(n, 7, np.int32),
             sltyp=np.full(n, 6, np.int32), slptyp=np.ones(n, np.int32),
             isc=np.full(n, 4, np.int32), ist=np.ones(n, np.int32),
             ice=np.zeros(n, np.int32))
    p = str(tmp_path / "dom.npz")
    np.savez(p, **d)
    tio.load_domain(p, device="cpu")
    d[field] = d[field].copy()
    d[field][3] = bad
    np.savez(p, **d)
    for load in (lambda: tio.load_domain(p, device="cpu"),
                 lambda: jio.load_domain(p)):
        with pytest.raises(ValueError, match=field):
            load()


def test_load_functions_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    np.savez(tmp_path / "domain.npz", lat=np.full(2, 0.5, np.float32))
    np.savez(tmp_path / "init.npz", tg=np.full(2, 300.0, np.float32))
    tio.save_restart(str(tmp_path / "r.npz"), _port_state(2), D(2000, 1, 1))
    for call in (lambda: tio.load_domain(str(tmp_path / "domain.npz")),
                 lambda: tio.load_init(str(tmp_path / "init.npz"), 2),
                 lambda: tio.load_restart(str(tmp_path / "r.npz"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------
# forcing


def _providers(case_dir, **kw):
    cfg = tconfig.Config.from_namelist(os.path.join(case_dir, "case.nml"))
    j_static = jio.load_domain(cfg.constfile)
    t_static = tio.static_to_host(tio.load_domain(cfg.constfile,
                                                  device="cpu"))
    return (cfg, tio.FileForcing(cfg.indir, cfg.infreq, t_static, **kw),
            jio.FileForcing(cfg.indir, cfg.infreq, j_static, **kw))


def test_file_forcing_equal_at_every_step(forcing_case):
    """A day at 900 s: every leaf of every step equal with ==."""
    cfg, tff, jff = _providers(forcing_case)
    for k in range(96):
        when = cfg.begdatetime + k * cfg.timestep
        got, want = tff(when), jff(when)
        assert got._fields == want._fields
        for name in Forcing._fields:
            a, b = np.asarray(getattr(got, name)), np.asarray(
                getattr(want, name))
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert (a == b).all(), (when, name)


def test_synthetic_forcing_equal(forcing_case):
    cfg, tff, jff = _providers(forcing_case, prefetch=False)
    tsyn, jsyn = tio.SyntheticForcing(tff.static), jio.SyntheticForcing(
        jff.static)
    for k in (0, 13, 50):
        when = cfg.begdatetime + k * cfg.timestep
        for a, b in zip(tsyn(when), jsyn(when)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("hours,steps", [(0, 4), (2, 8), (5, 3)])
def test_compact_chunk_equal(forcing_case, hours, steps):
    cfg, tff, jff = _providers(forcing_case, prefetch=False)
    when = cfg.begdatetime + datetime.timedelta(hours=hours)
    got = tio.compact_chunk(tff, when, steps, cfg.timestep)
    want = jio.compact_chunk(jff, when, steps, cfg.timestep)
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tio.FRAME_FIELDS == jio.FRAME_FIELDS
    assert set(tio.FRAME_FIELDS) == set(tio.FileForcing.INTERP) | set(
        tio.FileForcing.HOLD)
    assert set(tio.FileForcing.HOLD) == set(tio.FRAME_FIELDS) - \
        tio._INTERP_SET


def _exact_stack(provider, when, steps, ts):
    fo = [provider(when + i * ts) for i in range(steps)]
    return {name: np.stack([np.asarray(getattr(f, name)) for f in fo])
            for name in Forcing._fields}


def test_compact_expander_matches_exact_stack(forcing_case):
    """The tolerance of tests/test_compact_forcing.py."""
    cfg, tff, _jff = _providers(forcing_case, prefetch=False)
    when = cfg.begdatetime + datetime.timedelta(hours=2)
    steps, ts = 8, cfg.timestep
    exact = _exact_stack(tff, when, steps, ts)
    parts = tio.compact_chunk(tff, when, steps, ts)
    stacked = tio.make_chunk_expander()(*[tio._upload(np.asarray(p), "cpu")
                                          for p in parts])
    assert isinstance(stacked, Forcing)
    for name in Forcing._fields:
        leaf = getattr(stacked, name)
        assert leaf.dtype == torch.float32 and leaf.is_contiguous(), name
        assert tuple(leaf.shape) == (steps, 24), name
        a = exact[name].astype(np.float64)
        b = leaf.numpy().astype(np.float64)
        np.testing.assert_allclose(
            b, a, rtol=2e-6, atol=1e-5 * max(1.0, np.abs(a).max()),
            err_msg=f"compact forcing field {name} diverged")


@pytest.mark.parametrize("compact", [False, True], ids=["exact", "compact"])
def test_prefetcher_hands_over_stacked_contiguous_chunks(forcing_case,
                                                         compact):
    cfg, tff, _jff = _providers(forcing_case, prefetch=False)
    schedule = trun._chunk_schedule(
        cfg.begdatetime, cfg.begdatetime + datetime.timedelta(hours=5),
        cfg.timestep, cfg.outfreq, tconfig.as_cadence(cfg.resfreq), 8)
    pre = tio.ChunkPrefetcher(tff, schedule, cfg.timestep, "cpu",
                              compact=compact)
    try:
        for when, steps in schedule:
            got = pre.get()
            want = _exact_stack(tff, when, steps, cfg.timestep)
            for name in Forcing._fields:
                leaf = getattr(got, name)
                assert leaf.dtype == torch.float32 and leaf.is_contiguous()
                assert tuple(leaf.shape) == (steps, 24)
                if not compact:
                    np.testing.assert_array_equal(leaf.numpy(), want[name])
    finally:
        pre.close()
    assert not pre._t.is_alive()


def test_prefetcher_raises_the_workers_error(tmp_path):
    """A missing forcing file surfaces in the main thread."""
    static = tio.static_to_host(init_static(3, device="cpu"))
    empty = tmp_path / "ldasin"
    empty.mkdir()
    ff = tio.FileForcing(str(empty), datetime.timedelta(hours=1), static,
                         prefetch=False)
    pre = tio.ChunkPrefetcher(ff, [(D(2000, 1, 1), 2)],
                              datetime.timedelta(seconds=900), "cpu")
    with pytest.raises(FileNotFoundError):
        pre.get()
    pre.close()


# ---------------------------------------------------------------------
# the generated case, shards, geogrid


@pytest.mark.parametrize("fmt", ["nc", "npz"])
def test_conus_case_writes_what_make_case_writes(tmp_path, fmt):
    """Same seed, same arrays; with NetCDF the same bytes."""
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    conus_case(16, seed=5, days=1, outdir=a, fmt=fmt)
    _make_case().conus(16, seed=5, days=1, outdir=b, fmt=fmt)
    names = []
    for sub in ("", "ldasin"):
        got = sorted(f for f in os.listdir(os.path.join(a, sub))
                     if f.endswith("." + fmt))
        want = sorted(f for f in os.listdir(os.path.join(b, sub))
                      if f.endswith("." + fmt))
        assert got == want and got
        names += [os.path.join(sub, f) for f in got]
    assert len(names) == 2 + 26
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if fmt == "nc":
            assert filecmp.cmp(pa, pb, shallow=False), name
        da, db = tio.load_arrays(pa), jio.load_arrays(pb)
        assert sorted(da) == sorted(db), name
        for k in da:
            np.testing.assert_array_equal(da[k], db[k], err_msg=name)
    na = tconfig.read_namelist(os.path.join(a, "case.nml"))
    nb = jconfig.read_namelist(os.path.join(b, "case.nml"))
    strip = {k: (v.replace(a, "").replace(b, "") if isinstance(v, str)
                 else v) for k, v in na["NOAHMP_OFFLINE"].items()}
    assert strip == {k: (v.replace(b, "") if isinstance(v, str) else v)
                     for k, v in nb["NOAHMP_OFFLINE"].items()}


def test_shards_merge_to_the_unsharded_files(tmp_path):
    """Sharded ldasout windows and restarts merge into the bytes of the
    unsharded writer's; the JAX merge gives the same bytes."""
    n = 10
    rng = np.random.default_rng(2)
    state = init_state(n, device="cpu")
    state = state._replace(tg=torch.from_numpy(
        rng.uniform(270, 300, n).astype(np.float32)))
    means = {"fsh": torch.from_numpy(rng.normal(size=n).astype(np.float32)),
             "fsa": torch.from_numpy(rng.normal(size=n).astype(np.float32))}
    when = D(2000, 7, 1, 3)
    full_dir, shard_dir = tmp_path / "full", tmp_path / "shards"
    full = tio.OutputWriter(str(full_dir), 3600.0, fields=tuple(means))
    full.push_window(when, means, state)
    for lo, hi in ((0, 4), (4, 10)):
        w = tio.OutputWriter(str(shard_dir), 3600.0, fields=tuple(means),
                             shard=(lo, hi, n))
        w.push_window(when, means, state)
        tio.save_restart_shard(str(shard_dir / "restart_x.nc"), state,
                               when, (lo, hi, n))
    jax_copy = tmp_path / "jax_copy"
    jax_copy.mkdir()
    for f in os.listdir(shard_dir):
        with open(shard_dir / f, "rb") as src, open(jax_copy / f, "wb") as dst:
            dst.write(src.read())
    merged = tio.merge_shard_files(str(shard_dir))
    assert [os.path.basename(p) for p in merged] == ["200007010300.nc",
                                                     "restart_x.nc"]
    assert filecmp.cmp(merged[0], full._files[0], shallow=False)
    j_merged = jio.merge_shard_files(str(jax_copy))
    for p, q in zip(merged, j_merged):
        assert filecmp.cmp(p, q, shallow=False)
    st, when2 = tio.load_restart(merged[1], device="cpu")
    assert when2 == when
    for a, b in zip(st, state):
        assert torch.equal(a, b)
    # the command-line tool: nothing left to merge but the merged files
    os.remove(merged[0])
    tmerge.main([str(shard_dir), "--delete-shards"])
    assert sorted(os.listdir(shard_dir)) == ["200007010300.nc",
                                             "restart_x.nc"]
    assert filecmp.cmp(shard_dir / "200007010300.nc", full._files[0],
                       shallow=False)


def test_merge_refuses_a_missing_shard(tmp_path):
    state = init_state(6, device="cpu")
    tio.save_restart_shard(str(tmp_path / "r.nc"), state, D(2000, 1, 1),
                           (0, 4, 6))
    with pytest.raises(ValueError, match="cover 4 of 6"):
        tio.merge_shard_files(str(tmp_path))


def _geo_em(path):
    """A 5 x 8 geogrid with water, ice, a missing soil temperature and a
    monthly green fraction (the file of tests/test_geo.py)."""
    ny, nx = 5, 8
    rng = np.random.default_rng(3)
    lat = np.linspace(30.0, 45.0, ny)[:, None] + np.zeros((1, nx))
    lon = np.zeros((ny, 1)) + np.linspace(-110.0, -80.0, nx)[None, :]
    lu = rng.choice([2, 5, 7, 8, 11, 14], (ny, nx)).astype(np.float32)
    lu[0, :3] = 17.0
    lu[4, 7] = 15.0
    greenfrac = rng.uniform(0.2, 0.9, (12, ny, nx)).astype(np.float32)
    soiltemp = np.full((ny, nx), 282.0, np.float32)
    soiltemp[1, 1] = 0.0
    grid = ("Time", "south_north", "west_east")
    arrays = {
        "XLAT_M": lat[None].astype(np.float32),
        "XLONG_M": lon[None].astype(np.float32), "LU_INDEX": lu[None],
        "LANDMASK": (lu != 17.0).astype(np.float32)[None],
        "SCT_DOM": rng.integers(1, 12, (1, ny, nx)).astype(np.float32),
        "SLOPECAT": np.ones((1, ny, nx), np.float32),
        "SOILTEMP": soiltemp[None], "GREENFRAC": greenfrac[None]}
    tnetcdf.write_classic(
        path, arrays, dims={"Time": 1, "south_north": ny, "west_east": nx,
                            "month": 12},
        var_dims={**{k: grid for k in arrays if k != "GREENFRAC"},
                  "GREENFRAC": ("Time", "month", "south_north",
                                "west_east")},
        attrs={"MMINLU": "MODIFIED_IGBP_MODIS_NOAH", "ISWATER": 17,
               "ISICE": 15})
    return lu, greenfrac


def test_geo_em_ingestion_and_grid_round_trip(tmp_path):
    p = str(tmp_path / "geo_em.d01.nc")
    lu, greenfrac = _geo_em(p)
    static, mapping = tgeo.static_from_geo_em(p, month=7, device="cpu")
    n = mapping.n_points
    assert n == int(np.sum(lu != 17.0)) and static.lat.shape == (n,)
    assert static.lutyp.dtype == torch.int32
    assert not (static.lutyp == 17).any()
    assert int(static.ice.sum()) == int(np.sum(lu == 15.0))
    assert ((static.lat > 0.4) & (static.lat < 1.0)).all()
    assert int((static.tbot == 285.0).sum()) == 1
    gf = greenfrac.reshape(12, -1)[:, mapping.index]
    np.testing.assert_array_equal(static.shdfac.numpy(), gf[6])
    np.testing.assert_array_equal(static.shdmax.numpy(), gf.max(axis=0))
    assert tuple(static.zsoil.shape) == (n, 4)
    # the same domain through load_domain (validated, on the device)
    loaded = tio.load_domain(p, device="cpu")
    for a, b in zip(loaded, static):
        assert torch.equal(a, b)
    # land points -> grid -> land points, and the NetCDF grid file
    vals = torch.arange(n, dtype=torch.float32)
    grid = mapping.scatter(vals.numpy())
    assert grid.shape == (5, 8) and np.isnan(grid[0, 0])
    np.testing.assert_array_equal(mapping.gather(grid), vals.numpy())
    out = str(tmp_path / "grid.nc")
    tgeo.write_grid_output(out, mapping, {"FSH": vals})
    back = tnetcdf.read_arrays(out)
    np.testing.assert_array_equal(back["FSH"], grid)
    np.testing.assert_allclose(back["XLAT_M"][~np.isnan(grid)],
                               np.rad2deg(mapping.lat), rtol=1e-6)
    assert tnetcdf.read(out).attrs["MMINLU"] in (
        "MODIFIED_IGBP_MODIS_NOAH", b"MODIFIED_IGBP_MODIS_NOAH")


def test_output_writer_push_window_writes_means_and_snapshot(tmp_path):
    """A window's means as handed in (the run divides its device sums),
    the State's snapshot fields at the window's end, one file a window
    named by its end time."""
    n = 5
    state = init_state(n, device="cpu")
    w = tio.OutputWriter(str(tmp_path), 1800.0, fields=("fsh", "fsa"))
    t0 = D(2000, 7, 1)
    for k in (1, 2):
        means = {"fsh": torch.full((n,), 1.5 * k),
                 "fsa": torch.full((n,), 3.0 * k)}
        files = w.push_window(t0 + k * datetime.timedelta(seconds=1800),
                              means, state)
    assert [os.path.basename(f) for f in files] == ["200007010030.nc",
                                                    "200007010100.nc"]
    last = tio.load_arrays(files[-1])
    np.testing.assert_array_equal(last["fsh"], np.full(n, 3.0, np.float32))
    np.testing.assert_array_equal(last["fsa"], np.full(n, 6.0, np.float32))
    assert set(last) == {"fsh", "fsa"} | set(tio.OutputWriter.SNAPSHOT)
    np.testing.assert_array_equal(last["stc"], state.stc.numpy())


def test_containers_handed_to_the_step_are_contiguous(forcing_case):
    """On the card the fused step's plan refuses a leaf that is not
    contiguous: the domain (``zsoil`` is a broadcast view on the host),
    the init State and a provider's Forcing come out of
    ``convert.tree_on_device``
    contiguous, with the host's values."""
    cfg, tff, _jff = _providers(forcing_case, prefetch=False)
    host = tio._load_domain_host(cfg.constfile)
    assert host.zsoil.strides[0] == 0
    static = tree_on_device(tio.Static, host, "cpu")
    forcing = tree_on_device(Forcing, tff(cfg.begdatetime), "cpu")
    state = tree_on_device(State, tio.load_init(cfg.initfile, 24, "cpu"),
                           "cpu")
    for tree, ref in ((static, host), (forcing, tff(cfg.begdatetime)),
                      (state, None)):
        for name, leaf in zip(tree._fields, tree):
            assert leaf.is_contiguous(), name
            if ref is not None:
                np.testing.assert_array_equal(leaf.numpy(),
                                              getattr(ref, name))
    with pytest.raises(TypeError, match="float64"):
        tree_on_device(tio.Static, host._replace(
            lat=host.lat.astype(np.float64)), "cpu")
