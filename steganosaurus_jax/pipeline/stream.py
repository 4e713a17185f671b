"""Host/device pipelining across batches (the PP analog, SURVEY.md §2.3c).

JAX dispatch is asynchronous: a jitted call returns device futures
immediately, and the host only blocks when it pulls results back. The batch
cores exploit this *within* a batch; this module exploits it *across*
batches — while batch N's graphs execute on the device, the host runs batch
N+1's PNG decode (threaded), AEAD/KDF crypto, ECC frame packing, and device
upload. With host prep time h and device time d per batch, a depth-bounded
stream approaches max(h, d) per batch instead of h + d.

The reference has no analog: it is a one-image-per-process CLI
(SURVEY.md §2.3). These generators are the bulk-ingest surface the CLI batch
modes and bench use.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from steganosaurus_jax.config import Params
from steganosaurus_jax.pipeline.batch import (
    BatchEmbedResult,
    embed_batch,
    extract_dispatch,
)


def embed_stream(
    batches,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    mesh=None,
    verify: bool = False,
    max_retries: int = 2,
    depth: int = 2,
    layout: str = "nhwc",
):
    """Pipeline embed_batch over an iterable of batches.

    batches: iterable of (imgs, secrets), (imgs, secrets, salts), or
    (imgs, secrets, salts, master_key); imgs may be numpy or already
    device-resident. A per-batch master_key (4th element) overrides the
    stream-level key — when it CHANGES between batches, the new key's
    sequential turtle-walk expansion (~1.5 s/M-bit, the one host cost the
    AEAD/packing overlap cannot hide) is kicked onto a worker thread so it
    runs while the in-flight device batches execute (the walk cache is
    thread-safe; the later embed_batch finds it warm).

    Yields one BatchEmbedResult per batch, in order, with DEVICE-RESIDENT
    stego arrays (pull with np.asarray, or feed them straight to
    extract_stream). Up to `depth` batches are in flight: batch N+1's host
    crypto runs while batch N's embed graphs execute (verify=True adds
    device read-back verification, which syncs per batch and shrinks — but
    does not eliminate — the overlap window).
    """
    from steganosaurus_jax import crypto
    from steganosaurus_jax.pipeline.batch import (prefetch_piw_walks,
                                                  prefetch_walk)

    q: deque[BatchEmbedResult] = deque()
    pool: ThreadPoolExecutor | None = None

    def _drain():
        res = q.popleft()
        # Bound in-flight device memory/dispatch depth; yields stay async —
        # consumers that can, keep the array on device.
        import jax

        jax.block_until_ready(res.stego)
        return res

    try:
        last_mk = master_key
        for item in batches:
            imgs, secrets = item[0], item[1]
            salts = item[2] if len(item) > 2 else None
            mk = (item[3] if len(item) > 3 and item[3] is not None
                  else master_key)
            pw = password if mk is None else None
            if layout == "nchw":
                H, W = imgs.shape[2], imgs.shape[3]
            else:
                H, W = imgs.shape[1], imgs.shape[2]
            if mk != last_mk:
                if pool is None:
                    pool = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="walk-pf")
                pool.submit(prefetch_walk, pw, mk, params, H, W,
                            [len(s) for s in secrets])
                last_mk = mk
            if params.per_image_walk:
                # The mode's dominant host cost is the B salt-keyed payload
                # expansions (doc/SUMMARY.md): draw the salts NOW so the
                # expansions can run on a worker thread during the drain's
                # device wait; embed_batch pops them from the prefetch cache.
                if salts is None:
                    salts = [crypto.get_random_bytes(16) for _ in secrets]
                if pool is None:
                    pool = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="walk-pf")
                pool.submit(prefetch_piw_walks, pw, mk, params, H, W,
                            list(salts), [len(s) for s in secrets])
            # Drain BEFORE dispatching the new batch: the blocking device
            # wait is the window in which a just-submitted walk prefetch
            # makes progress (and the in-flight bound stays `depth`).
            if len(q) >= depth:
                yield _drain()
            q.append(embed_batch(imgs, secrets, password=pw,
                                 master_key=mk, params=params,
                                 salts=salts, mesh=mesh, device_resident=True,
                                 verify=verify, max_retries=max_retries,
                                 layout=layout))
        while q:
            yield _drain()
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def extract_stream(
    batches,
    password: str | None = None,
    master_key: bytes | None = None,
    params: Params = Params(),
    mesh=None,
    clen_hint: int | None = None,
    depth: int = 2,
    layout: str = "nhwc",
):
    """Pipeline extract_batch over an iterable of stego batches.

    batches: iterable of stego arrays, or (stego, master_key) tuples for
    per-batch key rotation (symmetric with embed_stream — a rotated key's
    walk expansion is prefetched on a worker thread while in-flight device
    passes complete).

    Yields one list[bytes | None] per batch, in order. The fused
    gather-decode pass for batch N+1 is dispatched before batch N's results
    are pulled and AEAD-opened, so the host AEAD/parse work and the device
    pass overlap.
    """
    from steganosaurus_jax.pipeline.batch import prefetch_walk

    q = deque()
    pool: ThreadPoolExecutor | None = None
    try:
        last_mk = master_key
        for item in batches:
            if isinstance(item, tuple):
                imgs, mk = item[0], (item[1] if item[1] is not None
                                     else master_key)
            else:
                imgs, mk = item, master_key
            pw = password if mk is None else None
            if mk != last_mk:
                if pool is None:
                    pool = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="walk-pf")
                if layout == "nchw":
                    H, W = imgs.shape[2], imgs.shape[3]
                else:
                    H, W = imgs.shape[1], imgs.shape[2]
                pool.submit(prefetch_walk, pw, mk, params, H, W,
                            [clen_hint or 0])
                last_mk = mk
            if len(q) >= depth:
                yield q.popleft().finalize()
            q.append(extract_dispatch(imgs, password=pw,
                                      master_key=mk, params=params,
                                      mesh=mesh, clen_hint=clen_hint,
                                      layout=layout))
        while q:
            yield q.popleft().finalize()
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def load_rgb_batches(paths, batch_size: int, threads: int = 8):
    """Threaded PNG ingest: decode `paths` with a thread pool (PIL releases
    the GIL around decode) and yield (B, H, W, 3) u8 stacks of consecutive
    same-shape images, each at most batch_size. A shape change flushes the
    current stack (batched graphs are shape-specialized).

    Decode is BACKPRESSURED: at most 2*threads images are in flight ahead
    of the consumer. (Executor.map submits every task eagerly — over a
    large directory of 4K covers, decoded frames would pile up unboundedly
    whenever the device pipeline stalls, eventually OOMing the host.)"""
    from steganosaurus_jax.io import image as image_io

    paths = list(paths)
    window = max(2 * threads, 1)
    with ThreadPoolExecutor(max_workers=threads) as pool:
        futs: deque = deque(
            pool.submit(image_io.load_rgb, p) for p in paths[:window])
        nxt = window
        cur: list[np.ndarray] = []
        cur_paths: list = []
        for path in paths:
            img = futs.popleft().result()
            if nxt < len(paths):
                futs.append(pool.submit(image_io.load_rgb, paths[nxt]))
                nxt += 1
            if cur and (img.shape != cur[0].shape
                        or len(cur) == batch_size):
                yield cur_paths, np.stack(cur)
                cur, cur_paths = [], []
            cur.append(img)
            cur_paths.append(path)
        if cur:
            yield cur_paths, np.stack(cur)
