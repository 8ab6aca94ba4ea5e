"""Offline-run I/O: domain/initialization loading, forcing providers,
output writing, and restart files; counterpart of
``noahmp_tpu/driver/io.py``.

The file layout is the JAX package's (run/case.nml: geo_em.d01.nc,
init.nc, ldasin/, ldasout/, restart/): classic NetCDF through the port's
own ``driver/netcdf.py`` (NetCDF-4 read via h5py), ``.npz`` beside it,
and a ``.nc`` path with a sibling ``.npz`` falls back transparently.
Either way a file maps variable name -> array; forcing files are named
``ldasin/YYYYMMDDHH.nc`` like LDAS convention.  A file written by either
package loads in the other.

What lives where.  The forcing providers (``FileForcing``,
``SyntheticForcing``, ``compact_chunk``) are numpy on the host and give
the JAX package's values bit for bit.  ``FileForcing`` keeps the
latitude terms of the solar formula across steps and, at
``POOL_MIN_POINTS`` points or more, splits each step's per-point work
over a small pool of threads (NumPy's loops release the interpreter
lock) at slice boundaries that keep every bit.  ``load_domain``,
``load_init`` and ``load_restart`` return tensors on the device they are
given (``None``: the card).  ``ChunkPrefetcher`` uploads each chunk's
stacked Forcing (a leaf with one value a step crosses as one value a
step), and ``make_chunk_expander`` interpolates a compact chunk on the
device with torch operations.  ``OutputWriter`` accumulates on the
device and fetches at the output cadence only.

Threads and the card.  The prefetcher uploads from its own thread and
``AsyncSink`` fetches from another.  Every thread of the program runs on
the legacy default stream, so an upload or a fetch is ordered with the
kernels the main thread enqueued before it, and neither needs an event.
A fetch also waits for kernels enqueued after the tensor it reads was
made: whatever the sink reads must therefore never be written again
(the run loop hands it new tensors, never an accumulator that a later
chunk updates in place).
"""

from __future__ import annotations

import concurrent.futures
import datetime
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..constants import NSOIL, TFRZ
from ..convert import tree_from_numpy
from ..state import State, Static, Forcing, init_state
from ..utils import _host
from . import netcdf, solar

STATE_FIELDS = State._fields

# FileForcing's split of a step's per-point work: the pool's threads, the
# size below which a step runs on the calling thread, and the alignment
# of the slices.  A vector loop's body and tail then cover the same
# points in a slice as in one call over the whole array, so a split
# gives the same bits as none.  Two threads, not more: each NumPy call
# of a part takes the interpreter lock, and with four the run loop's
# main thread waited longer for it than the assembly gained
# (scripts/forcing_pool_sweep.py on the card's 8-core host).
POOL_SIZE = max(1, min(2, (os.cpu_count() or 1) // 2))
POOL_MIN_POINTS = 32768
PART_ALIGN = 64

_pool = None
_pool_lock = threading.Lock()


def _forcing_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The process's pool for forcing parts, made on first use."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = concurrent.futures.ThreadPoolExecutor(
                POOL_SIZE, thread_name_prefix="noahmp-forcing-part")
        return _pool


def part_bounds(n: int, parts: int):
    """[lo, hi) slices of ``n`` points in at most ``parts`` pieces, each
    starting at a multiple of ``PART_ALIGN``."""
    size = -(-n // max(1, parts))
    size = max(PART_ALIGN, -(-size // PART_ALIGN) * PART_ALIGN)
    return [(lo, min(lo + size, n)) for lo in range(0, n, size)]


def _run_parts(fn, n: int, parts: int):
    """``fn(lo, hi)`` over ``part_bounds(n, parts)``: on the calling
    thread when that is one slice, else on the pool, waiting for every
    part.  A part's exception propagates."""
    bounds = part_bounds(n, parts)
    if len(bounds) <= 1:
        fn(0, n)
        return
    futures = [_forcing_pool().submit(fn, lo, hi) for lo, hi in bounds]
    concurrent.futures.wait(futures)
    for f in futures:
        f.result()


def _npz_path(path: str) -> str:
    if path.endswith(".nc") and not os.path.exists(path):
        alt = path[:-3] + ".npz"
        if os.path.exists(alt):
            return alt
    return path


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    path = _npz_path(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if netcdf.sniff(path):
        return netcdf.read_arrays(path)
    raise ValueError(f"unsupported input format for {path!r} "
                     "(expected NetCDF or .npz)")


def save_arrays(path: str, arrays: Dict[str, np.ndarray],
                format: Optional[str] = None):
    """``format``: None -> by extension (.nc classic, .nc4 NetCDF-4,
    else .npz); or 'classic' / 'nc4' explicitly for a .nc path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".nc4") or format in ("nc4", "hdf5", "netcdf4"):
        return netcdf.write_hdf5(path, arrays)
    if path.endswith(".nc") or format in ("nc", "classic"):
        return netcdf.write_classic(path, arrays)
    np.savez_compressed(path, **arrays)
    return path


# Valid 1-based index ranges for the per-point type fields (table row
# counts per params/tables.py: 27 veg classes, 19 soil types, 9 soil
# colors, 9 slope classes).  An out-of-range index would gather a wrong
# or undefined table row: corrupt domain/restart inputs must fail loudly
# here instead (the reference aborts on bad table indices,
# module_noahmp_utils.f90:43-53).
_INDEX_RANGES = {
    "lutyp": (1, 27), "sltyp": (1, 19), "isc": (1, 9),
    "slptyp": (1, 9), "ist": (1, 2), "ice": (-1, 1),
}


def validate_static(static: Static, where: str = "domain") -> Static:
    """Range-check per-point type indices; raise ValueError on any
    out-of-range value (which would silently zero physics downstream)."""
    for name, (lo, hi) in _INDEX_RANGES.items():
        v = _host(getattr(static, name))
        bad = (v < lo) | (v > hi)
        if bad.any():
            idx = np.flatnonzero(np.atleast_1d(bad).ravel())[:5]
            vals = np.atleast_1d(v).ravel()[idx]
            raise ValueError(
                f"{where}: {name} out of range [{lo},{hi}] at points "
                f"{idx.tolist()} (values {vals.tolist()})")
    return static


def static_to_host(static: Static) -> Static:
    """A Static of numpy arrays: what the forcing providers and the
    advisory budget checks read."""
    return Static(*[np.ascontiguousarray(_host(leaf)) for leaf in static])


def _load_domain_host(path: str) -> Static:
    real = _npz_path(path)
    if netcdf.sniff(real):
        ds = netcdf.read(real)
        names = {k.split("/")[-1].upper() for k in ds.variables}
        if "LU_INDEX" in names and ("XLAT_M" in names
                                    or "XLAT" in names):
            from . import geo
            return validate_static(static_to_host(
                geo.static_from_geo_em(real, device="cpu")[0]), where=path)
    d = load_arrays(path)
    n = len(np.atleast_1d(d["lat"]))

    def get(name, default, dtype=np.float32):
        if name in d:
            return np.broadcast_to(
                np.asarray(d[name], dtype), (n,)
                if np.ndim(d[name]) <= 1 else d[name].shape)
        return np.broadcast_to(np.asarray(default, dtype), (n,))

    zsoil = d.get("zsoil", np.array([-0.1, -0.4, -1.0, -2.0],
                                    np.float32))
    zsoil = np.broadcast_to(np.asarray(zsoil, np.float32),
                            (n, NSOIL))
    return validate_static(Static(
        lat=get("lat", 0.7), lutyp=get("lutyp", 7, np.int32),
        sltyp=get("sltyp", 6, np.int32),
        slptyp=get("slptyp", 1, np.int32),
        isc=get("isc", 4, np.int32), ist=get("ist", 1, np.int32),
        ice=get("ice", 0, np.int32), zsoil=zsoil,
        shdfac=get("shdfac", 0.7), shdmax=get("shdmax", 0.8),
        tbot=get("tbot", 285.0), zlvl=get("zlvl", 10.0)), where=path)


def load_domain(path: str, device=None) -> Static:
    """Static domain file -> Static of tensors on ``device`` (``None``:
    the card; batch axis = land points).

    WRF geogrid files (geo_em.d01.nc with XLAT_M/LU_INDEX 2-D fields)
    are ingested via driver/geo.py; flat per-point files map names
    directly."""
    return tree_from_numpy(Static, _load_domain_host(path)._asdict(),
                           device)


def load_init(path: str, n: int, device=None) -> State:
    """Initialization file -> State on ``device`` (``None``: the card);
    missing fields cold-start."""
    d = load_arrays(path)
    st = {k: v.numpy() for k, v in init_state(n, device="cpu")._asdict()
          .items()}
    updates = {}
    for name in STATE_FIELDS:
        if name in d:
            ref = st[name]
            updates[name] = np.broadcast_to(
                np.asarray(d[name], ref.dtype), ref.shape)
    # liquid water may not exceed total soil water (soil ice =
    # smc - swc would go negative and corrupt the water budget);
    # supplying only one of the two implies the other at cold start
    if "swc" in updates and "smc" not in updates:
        updates["smc"] = updates["swc"]
    elif "smc" in updates and "swc" not in updates:
        updates["swc"] = updates["smc"]
        # swc=smc forces zero initial soil ice; with sub-freezing soil
        # temperatures the user likely intended frozen soil (SH2O is an
        # independent input in the reference) — warn rather than guess
        stc = np.asarray(updates.get("stc", st["stc"]))
        if (stc[..., -NSOIL:] < TFRZ).any():
            import warnings
            warnings.warn(
                f"init {path}: only smc supplied; assuming swc=smc "
                "(zero soil ice) despite sub-freezing initial soil "
                "temperatures. Supply swc explicitly (or compute "
                "supercooled liquid via physics.soiltemp.frh2o) for a "
                "frozen cold start.", stacklevel=2)
    if "swc" in updates and (updates["swc"]
                             > updates["smc"] + 1e-6).any():
        raise ValueError(f"init {path}: swc (liquid) exceeds smc "
                         "(total soil water) — negative soil ice")
    st.update(updates)
    return tree_from_numpy(State, st, device)


def save_restart(path: str, state: State, when: datetime.datetime):
    arrays = {name: _host(getattr(state, name)) for name in STATE_FIELDS}
    arrays["_timestamp"] = np.asarray(when.isoformat())
    return save_arrays(path, arrays)


def save_restart_shard(path: str, state: State,
                       when: datetime.datetime, shard):
    """Restart shard of rows [lo, hi) of ``npoints``: the same
    ``.pLO-HI`` suffix scheme as a sharded OutputWriter;
    ``merge_shard_files`` on the restart directory reassembles full
    restart files."""
    lo, hi, npoints = shard
    arrays = {name: _local_block(getattr(state, name), lo, hi)
              for name in STATE_FIELDS}
    arrays["_timestamp"] = np.asarray(when.isoformat())
    arrays["_shard_lo"] = np.asarray(lo, np.int64)
    arrays["_shard_hi"] = np.asarray(hi, np.int64)
    arrays["_npoints"] = np.asarray(npoints, np.int64)
    fmt = os.path.splitext(path)[1].lstrip(".") or "nc"
    return save_arrays(f"{path}.p{lo:09d}-{hi:09d}", arrays,
                       format=fmt)


def load_restart(path: str, device=None):
    """Restart file -> (State on ``device``, model time).  ``None``
    means the card."""
    d = load_arrays(path)
    ts = np.asarray(d.pop("_timestamp")).ravel()[0]
    if isinstance(ts, bytes):
        ts = ts.decode()
    when = datetime.datetime.fromisoformat(str(ts))
    state = {name: np.asarray(d[name]) for name in STATE_FIELDS}
    # a corrupt restart poisons every downstream step; fail loudly
    for name in ("tg", "tv", "stc", "smc", "swc", "sneqv", "snowh"):
        if not np.isfinite(state[name]).all():
            raise ValueError(f"restart {path}: non-finite {name}")
    nsnow = state["nsnow"]
    if ((nsnow < 0) | (nsnow > 3)).any():
        raise ValueError(f"restart {path}: snow layer count out of "
                         "range [0,3]")
    return tree_from_numpy(State, state, device), when


class AsyncSink:
    """Ordered background executor for output-side I/O (window writes,
    restart saves).  Device->host fetches and file writes run on the
    worker thread so they overlap the model's device steps — the main
    loop never blocks on the download path.  Exceptions propagate: the
    next submit()/close() re-raises."""

    def __init__(self, name="noahmp-io"):
        import queue
        import threading
        self._q = queue.Queue(maxsize=8)
        self._err = None
        self._t = threading.Thread(target=self._run, name=name,
                                   daemon=True)
        self._t.start()

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            fn, args, kwargs = job
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001
                self._err = e

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, fn, *args, **kwargs):
        self._check()
        self._q.put((fn, args, kwargs))

    def close(self):
        self._q.put(None)
        self._t.join()
        self._check()


# ---------------------------------------------------------------------
# Compact (device-interp) chunk forcing.
#
# The exact pipeline uploads a fully-materialized (T, n) stack of all
# 15 Forcing fields per chunk even though the source data is hourly
# and most fields are linear interpolations of two hourly frames: at
# 131k points that is ~7.9 MB per 900 s step.  Compact mode uploads the
# unique hourly frames once plus per-step scalars, and the expander
# materializes the (T, n) stack ON DEVICE with torch operations (the
# JAX package's expander is a jitted XLA function, not a Pallas kernel):
# ~4x less host->device traffic, identical downstream contract.  Opt-in
# (forcing_mode="compact") because the device interpolation may differ
# from the host's by an ulp.
# ---------------------------------------------------------------------

FRAME_FIELDS = ("sfctmp", "sfcprs", "q2", "uu", "vv", "soldn", "lwdn",
                "prcp")
# mirrors FileForcing.INTERP/HOLD (defined below; asserted in tests)
_INTERP_SET = frozenset(FRAME_FIELDS) - {"prcp"}


def compact_chunk(provider: "FileForcing", when, steps, timestep):
    """Host-side compact representation of one chunk's forcing:
    (frames (H, 8, n), i0 (T,), w (T,), cosz (T, n), jd (T,),
    yearlen ()) plus the optional trace-gas constants."""
    from .config import _ANCHOR
    n = provider.static.lat.shape[0]
    secs = provider.infreq.total_seconds()
    hours = []          # unique frame times, in order
    hour_index = {}
    i0 = np.empty(steps, np.int32)
    w = np.empty(steps, np.float32)
    jd = np.empty(steps, np.float32)
    cosz = np.empty((steps, n), np.float32)
    yearlen = None
    for t in range(steps):
        now = when + t * timestep
        since = (now - _ANCHOR).total_seconds()
        t0 = _ANCHOR + datetime.timedelta(seconds=(since // secs) * secs)
        for tt in (t0, t0 + provider.infreq):
            if tt not in hour_index:
                hour_index[tt] = len(hours)
                hours.append(tt)
        i0[t] = hour_index[t0]
        w[t] = (now - t0).total_seconds() / secs
        yearlen = float(solar.year_length(now.year))
        jd64 = solar.julian_day(now)   # full f64, as the provider uses
        jd[t] = jd64                   # Forcing.julian is f32 anyway
        cosz[t] = solar.cos_zenith_from(
            *provider._lat_terms(), provider._lon64(t0, provider._load(t0)),
            jd64, yearlen)
    # consecutive-frame layout so the expander can index i0 and i0+1
    assert all(hour_index[h] == k for k, h in enumerate(hours))
    frames = np.empty((len(hours), len(FRAME_FIELDS), n), np.float32)
    consts = {}
    for k, h in enumerate(hours):
        d = provider._load(h)
        for j, f in enumerate(FRAME_FIELDS):
            frames[k, j] = np.broadcast_to(
                np.asarray(d[f], np.float32), (n,))
        if k == 0:
            for f, dflt in (("co2air", 39.0), ("o2air", 18900.0),
                            ("foln", 1.0)):
                consts[f] = np.broadcast_to(np.asarray(
                    d.get(f, dflt), np.float32), (n,)).copy()
    return (frames, i0, w, cosz, jd,
            np.float32(yearlen), consts["co2air"], consts["o2air"],
            consts["foln"])


def make_chunk_expander():
    """Device-side expansion of a compact chunk (its parts as tensors on
    one device, in ``compact_chunk``'s order) into the stacked (T, n)
    Forcing the chunked driver consumes: every leaf a contiguous (T, n)
    float32 tensor on that device."""

    def expand(frames, i0, w, cosz, jd, yearlen, co2air, o2air, foln):
        i0 = i0.long()
        a = frames[i0]          # (T, 8, n) — H is tiny, gather is cheap
        b = frames[i0 + 1]
        wt = w[:, None]
        T, n = cosz.shape
        fields = {}
        for j, f in enumerate(FRAME_FIELDS):
            if f in _INTERP_SET:
                fields[f] = (1.0 - wt) * a[:, j] + wt * b[:, j]
            else:                       # hold (prcp), LDAS-style
                fields[f] = a[:, j].contiguous()

        def rep(v):
            return v.expand(T, n).contiguous()

        return Forcing(
            sfctmp=fields["sfctmp"], sfcprs=fields["sfcprs"],
            psfc=fields["sfcprs"], uu=fields["uu"], vv=fields["vv"],
            q2=fields["q2"], soldn=fields["soldn"],
            lwdn=fields["lwdn"], prcp=fields["prcp"],
            cosz=cosz.contiguous(),
            co2air=rep(co2air[None]), o2air=rep(o2air[None]),
            foln=rep(foln[None]), julian=rep(jd[:, None]),
            yearlen=rep(yearlen.reshape(1, 1)))

    return expand


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """One host array as a tensor on ``device``: the prefetcher's only
    host-to-device copy."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _upload_steps(fo, device) -> Forcing:
    """The steps' Forcings (host arrays) stacked on ``device``: every
    leaf a contiguous (T, n) float32 tensor with storage of its own.  A
    leaf that holds one value a step (stride 0 at every step) crosses as
    a (T,) vector and is spread on the device; a leaf that is the same
    array as an earlier leaf at every step is copied on the device."""
    cols = [[np.asarray(x, np.float32) for x in xs] for xs in zip(*fo)]
    leaves = []
    for k, xs in enumerate(cols):
        twin = next((j for j in range(k)
                     if all(a is b for a, b in zip(xs, cols[j]))), None)
        if twin is not None:
            leaves.append(leaves[twin].clone())
        elif all(x.ndim == 1 and x.strides == (0,) for x in xs):
            per_step = _upload(np.array([x[0] for x in xs], np.float32),
                               device)
            leaves.append(per_step[:, None].expand(
                len(xs), xs[0].shape[0]).contiguous())
        else:
            leaves.append(_upload(np.stack(xs), device))
    return Forcing(*leaves)


class ChunkPrefetcher:
    """Builds the next chunks' stacked forcing on a background thread
    and ships them to the device while the current chunk computes.

    ``schedule``: iterable of (when, steps); for each entry the thread
    assembles the (steps, n) stacked Forcing (host-side provider calls +
    np.stack) and uploads it to ``device`` (``_upload_steps``): every
    leaf a contiguous (steps, n) float32 tensor there.  A bounded queue
    (depth 2) caps host+device memory at two chunks in flight.  The uploads are
    ordinary copies on the legacy default stream: ordered with the
    kernels enqueued before them, no event needed."""

    def __init__(self, provider, schedule, timestep, device,
                 depth=2, compact=False):
        import queue
        import threading
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()
        if compact and not isinstance(provider, FileForcing):
            # compact mode targets the file-driven case
            compact = False
        expander = make_chunk_expander() if compact else None

        def work():
            try:
                for when, steps in schedule:
                    if compact:
                        parts = compact_chunk(provider, when, steps,
                                              timestep)
                        with torch.no_grad():
                            stacked = expander(*[_upload(np.asarray(p),
                                                         device)
                                                 for p in parts])
                    else:
                        stacked = _upload_steps(
                            [provider(when + i * timestep)
                             for i in range(steps)], device)
                    if not self._put(stacked):
                        return
            except BaseException as e:  # noqa: BLE001
                self._err = e
                self._put(None)

        self._t = threading.Thread(target=work, name="noahmp-forcing",
                                   daemon=True)
        self._t.start()

    def _put(self, item):
        """Queue ``item`` unless closed; False once the consumer left."""
        import queue
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def get(self):
        out = self._q.get()
        if out is None and self._err is not None:
            raise self._err
        return out

    def close(self):
        """Stop the worker (after the last chunk, or when the run ends
        early) and wait for it."""
        self._stop.set()
        self._t.join()


class ForcingProvider:
    """Interface: forcing(when) -> Forcing for a batch of points."""

    def __call__(self, when: datetime.datetime) -> Forcing:
        raise NotImplementedError


class FileForcing(ForcingProvider):
    """Reads ``<indir>/YYYYMMDDHH[MM].npz`` files at ``infreq`` cadence
    and linearly interpolates state-like fields to the model time
    (precip is held constant over the input interval, LDAS-style).
    Returns a Forcing of numpy arrays; ``static`` is a Static of numpy
    arrays (``static_to_host``)."""

    INTERP = ("sfctmp", "sfcprs", "q2", "uu", "vv", "soldn", "lwdn")
    HOLD = ("prcp",)

    def __init__(self, indir: str, infreq: datetime.timedelta,
                 static: Static, prefetch: bool = True,
                 points_slice=None):
        """``points_slice=(lo, hi)``: only land points [lo, hi) are
        read (byte-range seeks for classic .nc, h5py dataset slicing
        for NetCDF-4; see netcdf.read_arrays_slice)."""
        self.indir = indir
        self.infreq = infreq
        self.static = static
        self.prefetch = prefetch
        self.points_slice = points_slice
        self._cache: Dict[str, Dict[str, np.ndarray]] = {}
        self._inflight = {}  # isoformat -> Thread
        self._lat = None     # float64 sin(lat), cos(lat)
        # what a step reads of the last few files, by file time; a
        # provider may be called from more than one thread
        self._lon: Dict[datetime.datetime, np.ndarray] = {}
        self._frames: Dict[datetime.datetime, np.ndarray] = {}
        self._terms_lock = threading.Lock()

    def _lat_terms(self):
        """float64 ``sin(lat)`` and ``cos(lat)`` of the domain."""
        with self._terms_lock:
            if self._lat is None:
                self._lat = solar.lat_terms(np.asarray(self.static.lat))
            return self._lat

    def _kept(self, cache, when, make):
        """``cache[when]``, made by ``make()`` when missing; the last
        four kept."""
        with self._terms_lock:
            value = cache.get(when)
            if value is None:
                value = make()
                while len(cache) >= 4:
                    cache.pop(next(iter(cache)))
                cache[when] = value
            return value

    def _lon64(self, when: datetime.datetime, d) -> np.ndarray:
        """float64 longitudes of the file at ``when`` (its float32
        ``lon``, or 0)."""
        return self._kept(self._lon, when, lambda: np.asarray(
            np.asarray(d.get("lon", 0.0), np.float32), np.float64))

    def _interp_frames(self, when: datetime.datetime, d) -> np.ndarray:
        """The ``INTERP`` fields of the file at ``when`` as one float32
        (len(INTERP), n) array, so that a part interpolates them all in
        a few NumPy calls."""
        n = self.static.lat.shape[0]
        return self._kept(self._frames, when, lambda: np.stack([
            np.broadcast_to(np.asarray(d[f], np.float32), (n,))
            for f in self.INTERP]))

    def _fname(self, when: datetime.datetime) -> str:
        stamp = when.strftime("%Y%m%d%H")
        if self.infreq < datetime.timedelta(hours=1):
            stamp += when.strftime("%M")
        for ext in (".npz", ".nc"):
            p = os.path.join(self.indir, stamp + ext)
            if os.path.exists(_npz_path(p)):
                return p
        raise FileNotFoundError(
            f"no forcing file for {when} in {self.indir}")

    def _read(self, path: str) -> Dict[str, np.ndarray]:
        if self.points_slice is None:
            return load_arrays(path)
        lo, hi = self.points_slice
        real = _npz_path(path)
        if netcdf.sniff(real):
            return netcdf.read_arrays_slice(real, lo, hi)
        # npz fallback: per-variable lazy zip reads, sliced after load
        d = load_arrays(real)
        return {k: (np.asarray(v)[lo:hi]
                    if np.ndim(v) >= 1 and np.shape(v)[0] >= hi else v)
                for k, v in d.items()}

    def _load(self, when: datetime.datetime) -> Dict[str, np.ndarray]:
        key = when.isoformat()
        t = self._inflight.pop(key, None)
        if t is not None:
            t.join()
        data = self._cache.get(key)
        if data is None:
            # read by reference: another thread may evict the entry
            data = self._read(self._fname(when))
            self._evict()
            self._cache[key] = data
        return data

    def _evict(self):
        try:
            while len(self._cache) > 4:
                self._cache.pop(next(iter(self._cache)), None)
        except (StopIteration, RuntimeError):
            pass  # concurrent mutation by the prefetch thread

    def _prefetch(self, when: datetime.datetime):
        """Read a forcing file on a background thread so the next
        interval boundary doesn't stall the device-bound time loop."""
        key = when.isoformat()
        if key in self._cache or key in self._inflight:
            return

        def work():
            try:
                data = self._read(self._fname(when))
            except FileNotFoundError:
                return  # the run may end before this interval
            self._evict()
            self._cache[key] = data

        import threading
        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._inflight[key] = t

    def __call__(self, when: datetime.datetime) -> Forcing:
        n = self.static.lat.shape[0]
        return self.assemble(when, POOL_SIZE if n >= POOL_MIN_POINTS
                             else 1)

    def assemble(self, when: datetime.datetime, parts: int) -> Forcing:
        """The Forcing at ``when``, its per-point work (``cosz`` and the
        interpolated fields) split over ``parts`` slices of the point
        axis on the pool (one slice: on the calling thread).  Every
        split gives the same bits."""
        # naive model-calendar flooring (timezone-independent)
        from .config import _ANCHOR
        secs = self.infreq.total_seconds()
        since = (when - _ANCHOR).total_seconds()
        t0 = _ANCHOR + datetime.timedelta(seconds=(since // secs) * secs)
        t1 = t0 + self.infreq
        w = (when - t0).total_seconds() / secs
        d0 = self._load(t0)
        d1 = self._load(t1) if w > 0 else d0
        if self.prefetch:
            self._prefetch(t1 if w == 0 else t1 + self.infreq)

        n = self.static.lat.shape[0]
        yearlen = float(solar.year_length(when.year))
        jd = solar.julian_day(when)
        sin_lat, cos_lat = self._lat_terms()
        lon = self._lon64(t0, d0)
        a = self._interp_frames(t0, d0)
        b = self._interp_frames(t1, d1) if w > 0 else a
        cosz = np.empty(n, np.float32)
        fields = np.empty(a.shape, np.float32)

        def part(lo, hi):
            cosz[lo:hi] = solar.cos_zenith_from(
                sin_lat[lo:hi], cos_lat[lo:hi],
                lon if lon.ndim == 0 else lon[lo:hi], jd, yearlen)
            # every INTERP field at once, (1 - w) a + w b, written in
            # place: a temporary of the whole width costs more than this
            dst = fields[:, lo:hi]
            np.multiply(a[:, lo:hi], 1.0 - w, out=dst)
            np.add(dst, w * b[:, lo:hi], out=dst)

        _run_parts(part, n, parts)
        out = dict(zip(self.INTERP, fields))

        # hold returns read-only numpy views aliasing _cache entries;
        # cache arrays are never mutated in place (the prefetch thread
        # only inserts whole new entries), so the views stay valid.  Any
        # future in-place writer must copy.
        def hold(name, default=None):
            if name in d0 or default is None:
                return np.broadcast_to(np.asarray(d0[name], np.float32),
                                       (n,))
            return one(default)

        def one(v):
            """One value for every point: a stride-0 view, which the
            prefetcher uploads as one value a step."""
            return np.broadcast_to(np.float32(v), (n,))

        return Forcing(
            sfctmp=out["sfctmp"], sfcprs=out["sfcprs"],
            psfc=out["sfcprs"], uu=out["uu"], vv=out["vv"],
            q2=out["q2"], soldn=out["soldn"], lwdn=out["lwdn"],
            prcp=hold("prcp"), cosz=cosz,
            co2air=hold("co2air", 39.0), o2air=hold("o2air", 18900.0),
            foln=hold("foln", 1.0), julian=one(jd), yearlen=one(yearlen))


class SyntheticForcing(ForcingProvider):
    """Idealized diurnal-cycle forcing (the reference repo ships no
    forcing data; this generates the offline case's meteorology)."""

    def __init__(self, static: Static, tmean=288.0, tamp=8.0,
                 solmax=800.0, prcp=0.0, q2=0.007, wind=3.0,
                 lwdn=330.0, sfcprs=90000.0):
        self.static = static
        self.tmean, self.tamp = tmean, tamp
        self.solmax, self.prcp = solmax, prcp
        self.q2, self.wind, self.lwdn = q2, wind, lwdn
        self.sfcprs = sfcprs

    def __call__(self, when: datetime.datetime) -> Forcing:
        n = self.static.lat.shape[0]
        yearlen = float(solar.year_length(when.year))
        jd = solar.julian_day(when)
        cosz = solar.cos_zenith(np.asarray(self.static.lat), 0.0, jd,
                                yearlen)
        day = np.maximum(cosz, 0.0)
        sfctmp = self.tmean + self.tamp * (day - 0.3)
        soldn = self.solmax * day

        def rep(v):
            return np.broadcast_to(np.asarray(v, np.float32), (n,))

        return Forcing(
            sfctmp=rep(sfctmp), sfcprs=rep(self.sfcprs),
            psfc=rep(self.sfcprs), uu=rep(self.wind), vv=rep(1.0),
            q2=rep(self.q2), soldn=rep(soldn), lwdn=rep(self.lwdn),
            prcp=rep(self.prcp), cosz=rep(cosz), co2air=rep(39.0),
            o2air=rep(18900.0), foln=rep(1.0), julian=rep(jd),
            yearlen=rep(yearlen))


class OutputWriter:
    """Writes time-stamped output files of window means at the
    configured cadence (the reference's ldasout contract); the run
    accumulates the window on the device."""

    def __init__(self, outdir: str, outfreq,
                 fields=("fsa", "fsr", "fira", "fsh", "fcev", "fgev",
                         "fctr", "ssoil", "trad", "ecan", "etran",
                         "edir", "runsrf", "runsub", "fsno", "albedo",
                         "gpp", "nee"), fmt: str = "nc",
                 shard: Optional[tuple] = None):
        """``shard=(lo, hi, npoints)``: this writer owns land points
        [lo, hi) of ``npoints`` and writes per-window SHARD files
        ``<stamp>.<fmt>.pLO-HI`` containing only that slice;
        ``merge_shard_files`` reassembles the gridded file offline."""
        from .config import as_cadence
        self.outdir = outdir
        self.outfreq = as_cadence(outfreq)
        self.fields = fields
        self.fmt = fmt
        self.shard = shard
        self._files = []

    SNAPSHOT = ("tg", "tv", "sneqv", "snowh", "zwt", "smc", "swc",
                "stc", "canliq", "canice", "lai")

    def push_window(self, when, means, state: State):
        """Write one output file directly from precomputed window means
        (the chunked driver accumulates on device inside the chunk and
        fetches only at the cadence boundary)."""
        return self._write(when, means, state)

    def _write(self, when, means, state: State):
        if self.shard is not None:
            return self._write_shard(when, means, state)
        arrays = {f: np.asarray(_host(v), np.float32)
                  for f, v in means.items()}
        # instantaneous prognostics snapshot
        for name in self.SNAPSHOT:
            arrays[name] = _host(getattr(state, name))
        path = os.path.join(
            self.outdir, when.strftime("%Y%m%d%H%M") + "." + self.fmt)
        self._files.append(save_arrays(path, arrays))
        return self._files

    def _write_shard(self, when, means, state: State):
        lo, hi, npoints = self.shard
        arrays = {f: _local_block(v, lo, hi).astype(np.float32)
                  for f, v in means.items()}
        for name in self.SNAPSHOT:
            arrays[name] = _local_block(getattr(state, name), lo, hi)
        arrays["_shard_lo"] = np.asarray(lo, np.int64)
        arrays["_shard_hi"] = np.asarray(hi, np.int64)
        arrays["_npoints"] = np.asarray(npoints, np.int64)
        path = os.path.join(
            self.outdir, when.strftime("%Y%m%d%H%M") + "." + self.fmt
            + f".p{lo:09d}-{hi:09d}")
        self._files.append(save_arrays(path, arrays, format=self.fmt))
        return self._files


def _local_block(arr, lo, hi):
    """Rows [lo, hi) of a batch-major array or tensor, on the host.  A
    leaf of hi - lo rows is taken whole: it holds those rows already (a
    rank's own block under a mesh, ``dist/mesh.py``)."""
    if arr.shape[0] == hi - lo:
        lo, hi = 0, hi - lo
    if isinstance(arr, torch.Tensor):
        return arr[lo:hi].detach().cpu().numpy()
    return np.asarray(arr[lo:hi])


def merge_shard_files(outdir: str, delete_shards: bool = False):
    """Reassemble sharded ldasout windows (``<stamp>.nc.pLO-HI`` files
    from sharded OutputWriters) into gridded ``<stamp>.nc`` files.
    Deterministic (shards sorted by lo; classic-NetCDF writer is
    byte-stable), so re-merging reproduces identical bytes.  Returns
    the list of merged file paths."""
    import re
    from collections import defaultdict
    groups = defaultdict(list)
    pat = re.compile(r"^(?P<stem>.+)\.p(?P<lo>\d{9})-(?P<hi>\d{9})$")
    for name in sorted(os.listdir(outdir)):
        m = pat.match(name)
        if m:
            groups[m.group("stem")].append(
                (int(m.group("lo")), int(m.group("hi")),
                 os.path.join(outdir, name)))
    merged = []
    for stem, parts in sorted(groups.items()):
        parts.sort()
        full: Dict[str, np.ndarray] = {}
        npoints = None
        covered = 0
        for lo, hi, path in parts:
            d = load_arrays(path)
            npoints = int(np.asarray(d.pop("_npoints")))
            d.pop("_shard_lo"), d.pop("_shard_hi")
            for k, v in d.items():
                if k not in full:
                    full[k] = np.zeros((npoints,) + np.shape(v)[1:],
                                       np.asarray(v).dtype)
                full[k][lo:hi] = v
            covered += hi - lo
        if npoints is None or covered != npoints:
            raise ValueError(
                f"{stem}: shards cover {covered} of {npoints} points")
        merged.append(save_arrays(os.path.join(outdir, stem), full))
        if delete_shards:
            for _lo, _hi, path in parts:
                os.remove(path)
    return merged
