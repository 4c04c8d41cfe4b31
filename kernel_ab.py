#!/usr/bin/env python3
"""A/B of the flash forward kernel's batch and depth, and of the redesigned
kernels against a parent's sources, on one CUDA card.

  * flash kernel (a): ``pytorch_geometric_tpu_torch/csrc/flash_softmax.cu``
    copied under ``_archive/ab/`` with its forward instanced at every
    (gathered row floats a batch, batches in flight) of {8, 16, 32} x {1,
    2} for the 16-byte layouts these shapes take (the library the package
    builds holds only the wrappers' choice), timed at path K's two layers
    (``chip_smoke.products_graph`` with a self loop per node; layer 2's C =
    47 padded to 48 as the flash route pads it), path L's layer 1 (GATv2, H
    = 4, C = 64, path C's graph with self loops) and path M's (the dot form,
    path C's graph), each output within 1e-5 of max(1, max |out|) of the
    package's kernel;
  * with ``--parent DIR`` (a directory holding a parent's
    ``flash_softmax.cu``, ``sddmm.cu`` and ``vec.cuh``, e.g. from ``git
    show``): the parent's kernel (a) at the same shapes (at layer 2 on the
    unpadded C = 47, as it ran) and its per-edge dot kernel at its own slice
    rule, beside the package's (as its wrapper chooses, path D saying its
    destinations come in runs as its grad_p_u does, so taking the runs arm;
    the other arm; and the tree arm at every slice shape it takes), at path
    I's shapes (edge order, H*F = 256 and 40, both dtypes at 256) and path
    D's (slot order). Parent and change in turns: parent, change, change,
    parent.

  * ``--only policy``: the SpMM regime sweep that sets the port's policy
    defaults (``ops/spmm.py``). Each arm runs through the public ``spmm``
    (forward, ``reduce='sum'``, unit weights, inference) with its regime
    forced: the dense cache (float32 and bf16, ``fill_cache(dense_weight=
    ones, cache_dtype=...)``), the uncached dense regime, kernel 1 over the
    cached CSC (``'kernel'``), kernel 1 over a raw COO whose CSC is sorted
    in the call (``'kernel uncached'``), the windowed regime over
    ``fill_cache(windowed=True)``'s layouts, the chunked regime over the raw
    COO (JAX's 1 GB chunks), and the block cache on clustered graphs. The
    grid: random graphs of {1k, 10k, 30k, 100k} nodes, average degree {10,
    33, 100}, F in {16, 64, 128} (dense arms up to 30k nodes); path A's
    clustered graph (``chip_smoke.path_a_graph``, F = 64) with the block
    cache; and the products-like graph (``chip_smoke.products_graph``,
    2,449,029 nodes, 123,718,280 edges, F = 100 and 64), where the windowed
    regime also runs one launch a window with the accumulator as kernel 1's
    ``base`` (the design the port did not take), and the layouts' build
    times and bytes are read. A training row (forward and backward, the
    weights requiring a gradient) times the weighted arms at 100k nodes,
    degree 100, F = 64. Each reading: CUDA-event ms per call over 20
    back-to-back calls after 3 (what an eager caller waits), the device
    time (``torch.profiler``), and up to 10k nodes, for the arms a captured
    forward can run (the cached CSC, the windowed layouts, the dense
    caches), CUDA-event ms per replay of the call captured in a CUDA graph
    (what a captured path waits, as the main paths are served). A row's
    ``fastest`` is by the captured time where the row has one, else by the
    device time; ``fastest_eager`` by the eager one.
    ``--policy-part small`` runs the rows up to 10k nodes and the training
    row only.

Device time per launch from ``torch.profiler`` over whole windows
(``chip_smoke.whole_window``), summed over the kernel's own launches. Prints
the card's name and power limit first, then every reading; ``--out FILE``
also writes them as JSON.

Usage: ``python3 kernel_ab.py [--seed 0] [--parent DIR] [--only
flash|dot|policy] [--policy-part all|small] [--out FILE]`` from the root of a checkout, on a machine
with one CUDA card and ``nvcc``.
"""

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
AB_DIR = ROOT / '_archive' / 'ab'
# kernel (a)'s variants: gathered row floats a batch, batches in flight
FWD_VARIANTS = tuple((f, p) for f in (8, 16, 32) for p in (1, 2))
# the A/B copy's launch_batch: kernel (a) only, at every variant, for the
# 16-byte layouts of one slot a head per lane (K, L and M take no other)
AB_LAUNCH_BATCH = '''template <int FORM, int W, int NH, int PER>
cudaError_t launch_batch(int pass, const FlashArgs& a, cudaStream_t st) {
  constexpr int F = NH * PER * W;
  if constexpr (W == 4 && PER == 1 && NH <= 2) {
    if (pass != kFwd) return cudaErrorInvalidValue;
#define PGT_AB(FL, P)                                                     \\
  if (a.unroll == edges_a_batch(FL, F) && a.depth == P)                   \\
    return launch_pass<kFwd, FORM, W, NH, PER, edges_a_batch(FL, F), P>(a, \\
                                                                        st);
    PGT_AB(8, 1) PGT_AB(8, 2) PGT_AB(16, 1) PGT_AB(16, 2) PGT_AB(32, 1)
    PGT_AB(32, 2)
#undef PGT_AB
  }
  return cudaErrorInvalidValue;
}
'''


def log(*a):
    print(*a, flush=True)


def ab_source(src: str) -> str:
    """The flash source with ``launch_batch`` replaced by the A/B's."""
    pat = re.compile(r'template <int FORM, int W, int NH, int PER>\n'
                     r'cudaError_t launch_batch\(.*?\n}\n', re.S)
    out, n = pat.subn(lambda _: AB_LAUNCH_BATCH, src)
    if n != 1:
        raise RuntimeError('kernel_ab: launch_batch not found in the flash '
                           'source')
    return out


def build(jobs):
    """``{name: (source, library)}``, one nvcc each, all at once, with the
    package's flags."""
    from pytorch_geometric_tpu_torch import csrc
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [csrc.nvcc_path(), *csrc.NVCC_FLAGS, '-o', str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, lib) in jobs.items()}
    for name, p in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f'kernel_ab: build of {name} failed:\n'
                               f'{text[-4000:]}')
        regs = [int(r) for r in re.findall(r'Used (\d+) registers', text)]
        spills = len(re.findall(r'[1-9]\d* bytes spill stores', text))
        log(f'[build] {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} '
            f'registers, {spills} spill')
        if len(regs) <= 32:
            for fn, r in re.findall(r'Function properties for (\S+)\n.*?'
                                    r'Used (\d+) registers', text, re.S):
                log(f'[build]   {name} {fn[:60]}: {r} registers')
    log(f'[build] {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s')
    return {name: ctypes.CDLL(str(lib)) for name, (_, lib) in jobs.items()}


def entry(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def kernel_ms(torch, fn, part, calls):
    """Device ms per call of the kernels whose name holds ``part``."""
    import chip_smoke as cs
    rows, _, _ = cs.whole_window(torch, fn, calls)
    return sum(t for name, t, _ in rows if part in name)


def fwd_call(torch, fn, ops, plan, shape, lanes=None):
    """One launch of a kernel (a) entry point ``fn`` over ``plan``; the
    output. ``lanes`` overrides the team's lanes (a parent's kernel (a)
    takes one team of ``team_lanes(c)`` lanes per (row, head))."""
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    h, c = ops.heads, ops.columns
    kw = dict(dtype=torch.float32, device='cuda')
    out = torch.empty((plan.n_rows, h * c), **kw)
    m = torch.empty((plan.n_rows, h), **kw)
    l = torch.empty((plan.n_rows, h), **kw)
    (ps, ps2, pv), tickets = fs._scratch(plan, h, h * c, out, 1)
    args = fs._args(ops, plan, shape, m=m, l=l, out=out, tickets=tickets,
                    part_s=ps, part_s2=ps2, part_v=pv)
    if lanes is not None:
        args.g_lanes = lanes
    err = fn(ctypes.addressof(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'kernel_ab: flash forward launch failed: {err}')
    return out


def flash_shapes(torch, seed):
    """``(label, ops, unpadded ops or None, s, d, rel, n_dst)`` at K's two
    layers, L's layer 1 and M's layer 1, random tables from ``seed``."""
    import chip_smoke as cs
    from pytorch_geometric_tpu_torch.ops import edge_attention as ea
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    g = torch.Generator(device='cuda').manual_seed(seed + 11)
    n = cs.N_PRODUCTS
    coo = cs.products_graph(n, cs.E_PRODUCTS, seed)
    loops = np.arange(n, dtype=np.int32)
    ks = torch.as_tensor(np.concatenate([coo[0], loops]), device='cuda')
    kd = torch.as_tensor(np.concatenate([coo[1], loops]), device='cuda')
    del coo
    rng = np.random.default_rng(seed)
    npc = cs.PC_NODES
    pc = rng.integers(0, npc, (2, cs.PC_EDGES)).astype(np.int32)
    lp = np.arange(npc, dtype=np.int32)
    keep = pc[0] != pc[1]
    ls = torch.as_tensor(np.concatenate([pc[0][keep], lp]), device='cuda')
    ld = torch.as_tensor(np.concatenate([pc[1][keep], lp]), device='cuda')
    ms, md = (torch.as_tensor(pc[0], device='cuda'),
              torch.as_tensor(pc[1], device='cuda'))
    hc = cs.PC_HIDDEN // cs.PC_HEADS
    for label, form, h, c, s, d, nn in (
            ('K layer 1', 'gat', 4, 16, ks, kd, n),
            ('K layer 2', 'gat', 1, cs.PR_CLASSES, ks, kd, n),
            ('L layer 1', 'gatv2', cs.PC_HEADS, hc, ls, ld, npc),
            ('M layer 1', 'dot', cs.PC_HEADS, hc, ms, md, npc)):
        sw = h if form == 'gat' else h * c
        src = torch.randn(nn, sw, device='cuda', generator=g)
        dst = torch.randn(nn, sw, device='cuda', generator=g)
        val = (src if form == 'gatv2' else
               torch.randn(nn, h * c, device='cuda', generator=g))
        extra = rel = None
        if form == 'gatv2':
            extra = torch.randn(h * c, device='cuda', generator=g) / \
                math.sqrt(c)
        if form == 'dot':
            extra = torch.full((1, h), 1 / math.sqrt(c), device='cuda')
            rel = torch.zeros(s.shape[0], dtype=torch.int64, device='cuda')
        ops = fs.FlashOperands(form, h, src, dst, val, extra, 0.2)
        cp = -(-c // ea.ALIGN_COLUMNS) * ea.ALIGN_COLUMNS
        padded = ops
        if cp != c:
            padded = ops._replace(val=ea._pad_heads(val, h, c, cp))
        yield (label, padded, ops if cp != c else None, s.long(), d.long(),
               rel, nn)


def flash_ab(torch, libs, seed, parent):
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    vp = [ctypes.c_void_p, ctypes.c_void_p]
    ab = entry(libs['ab'], 'pgt_flash_fwd', vp)
    shipped = fs._kernel('pgt_flash_fwd')
    old = entry(libs['parent_flash'], 'pgt_flash_fwd', vp) if parent else None
    rows = []
    for label, ops, unpadded, s, d, rel, nd in flash_shapes(torch, seed):
        plan = fs.dst_plan(s, d, rel, nd, False)
        h, c = ops.heads, ops.columns
        chosen = fs.kernel_shape(ops, 'fwd', torch.empty(
            (1, h * c), device='cuda'))
        ref = fwd_call(torch, shipped, ops, plan, chosen)
        lim = 1e-5 * max(1.0, float(ref.abs().max()))
        row = {'shape': label, 'form': ops.form, 'H': h, 'C': c,
               'edges': int(s.shape[0]), 'chosen': chosen._asdict(),
               'ms': {}}
        turns = []
        if old is not None:
            base = unpadded or ops
            lanes = min(fs._pow2(base.columns), 32)
            turns.append(('parent', lambda: fwd_call(
                torch, old, base, plan, chosen, lanes)))
        for floats, depth in FWD_VARIANTS:
            shape = chosen._replace(unroll=min(16, max(
                1, floats // (chosen.nv * chosen.vec))), depth=depth)
            out = fwd_call(torch, ab, ops, plan, shape)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not err <= lim:
                raise AssertionError(f'kernel_ab: {label} variant {floats}, '
                                     f'{depth}: {err} from the package\'s '
                                     f'kernel (limit {lim})')
            turns.append((f'{floats} floats, depth {depth}',
                          lambda shape=shape: fwd_call(torch, ab, ops, plan,
                                                       shape)))
        turns.append(('package', lambda: fwd_call(torch, shipped, ops, plan,
                                                  chosen)))
        order = turns + turns[::-1]
        for name, fn in order:
            ms = kernel_ms(torch, fn, 'flash_fwd_kernel', 5)
            row['ms'].setdefault(name, []).append(ms)
        for name, ts in row['ms'].items():
            log(f'[ab] flash (a) {label} ({ops.form} H={h} C={c}): {name}: '
                + ' / '.join(f'{t:.4f}' for t in ts) + ' ms')
        rows.append(row)
        del plan, ref
        torch.cuda.empty_cache()
    return rows


def dot_ab(torch, libs, seed, parent):
    import chip_smoke as cs
    from pytorch_geometric_tpu_torch.ops.edge_dot import (dot_slice_widths,
                                                          dot_vec, edge_dot,
                                                          runs_arm)
    from pytorch_geometric_tpu_torch.ops.gather import MIX_L2_SHARE
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    old = {arm: entry(libs['parent_dot'], f'pgt_edge_dot_{arm}',
                      [vp] * 6 + [ll] * 5 + [i] * 5 + [vp])
           for arm in ('f32', 'bf16')}
    # variants of the package's source: the package's interface
    variants = {name[4:]: {arm: entry(lib, f'pgt_edge_dot_{arm}',
                                      [vp] * 7 + [ll] * 5 + [i] * 7 + [vp])
                           for arm in ('f32', 'bf16')}
                for name, lib in libs.items() if name.startswith('dot ')}
    pc = cs.build_path_c(torch, seed)
    ei, n = pc['ei'], cs.PC_NODES
    blk = ei.blocked
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    g = torch.Generator('cuda').manual_seed(seed + 8)
    rows = []

    def parent_call(a, b, ia, ib):
        h, f = a.shape[1:]
        fit = [k for k in range(1, h + 1) if h % k == 0 and max(
            a.shape[0], b.shape[0]) * k * f * a.element_size()
            <= MIX_L2_SHARE * l2]
        hs = max(fit) if fit else 1
        out = torch.empty((ia.shape[0], h), dtype=a.dtype, device='cuda')
        err = old['bf16' if a.dtype == torch.bfloat16 else 'f32'](
            a.data_ptr(), b.data_ptr(), ia.data_ptr(), ib.data_ptr(), None,
            out.data_ptr(), ia.shape[0], a.shape[0], b.shape[0],
            a.stride(0), b.stride(0), h, f, hs,
            int(ia.dtype == torch.int64), int(ib.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f'kernel_ab: parent dot launch failed: {err}')
        return out

    def variant_call(fns, a, b, ia, ib, vec, hs, cs):
        h, f = a.shape[1:]
        e = ia.shape[0]
        p = 1 << (f // vec - 1).bit_length()
        leaves = p // cs
        ncs = -(-(f // vec) // leaves)
        out = torch.empty((e, h), dtype=a.dtype, device='cuda')
        part = (torch.empty((ncs, e, h), device='cuda') if ncs > 1
                else None)
        err = fns['bf16' if a.dtype == torch.bfloat16 else 'f32'](
            a.data_ptr(), b.data_ptr(), ia.data_ptr(), ib.data_ptr(), None,
            out.data_ptr(), None if part is None else part.data_ptr(), e,
            a.shape[0], b.shape[0], a.stride(0), b.stride(0), h, f, vec, hs,
            leaves, int(ia.dtype == torch.int64),
            int(ib.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f'kernel_ab: dot variant launch failed: {err}')
        return out

    with torch.inference_mode():
        for path, order, ia, ib in (('I', 'edge', ei.coo[0], ei.coo[1]),
                                    ('D', 'slot', blk.src, blk.dst)):
            for f, dt in ((cs.PC_HIDDEN // cs.PC_HEADS, torch.float32),
                          (cs.PC_CLASSES, torch.float32),
                          (cs.PC_HIDDEN // cs.PC_HEADS, torch.bfloat16)):
                h = cs.PC_HEADS
                a = torch.randn(n, h, f, device='cuda', generator=g).to(dt)
                b = torch.randn(n, h, f, device='cuda', generator=g).to(dt)
                ref = parent_call(a, b, ia, ib)
                named = True if path == 'D' else None
                runs = runs_arm(f, named)
                new = edge_dot(a, b, ia, ib, runs=named)
                torch.cuda.synchronize()
                lim = (1e-5 if dt == torch.float32 else 1e-2) * float(
                    ref.float().abs().max())
                err = float((new.float() - ref.float()).abs().max())
                if not err <= lim:
                    raise AssertionError(f'kernel_ab: dot path {path} F={f} '
                                         f'{dt}: {err} from the parent')
                vec = dot_vec(a, b, f, h * f, h * f)
                turns = [('parent', lambda: parent_call(a, b, ia, ib)),
                         ('package', lambda: edge_dot(a, b, ia, ib,
                                                      runs=named)),
                         (f"package, the {'tree' if runs else 'runs'} arm",
                          lambda: edge_dot(a, b, ia, ib, runs=not runs))]
                # the tree arm at every slice shape
                widths = dot_slice_widths(h, f, vec)
                turns += [(f'package, {hs} heads in {cs} column slices',
                           lambda hs=hs, cs=cs: edge_dot(
                               a, b, ia, ib, slice_heads=hs, col_slices=cs,
                               runs=False))
                          for hs, cs in widths]
                for name, fns in variants.items():
                    first = None
                    for hs, ncol in dot_slice_widths(h, f, vec)[:5]:
                        got = variant_call(fns, a, b, ia, ib, vec, hs, ncol)
                        torch.cuda.synchronize()
                        first = got if first is None else first
                        if not torch.equal(got, first):
                            raise AssertionError(f'kernel_ab: variant {name} '
                                                 'changes the bits with its '
                                                 'slices')
                        turns.append((f'{name}, {hs} heads in {ncol} column '
                                      'slices', lambda fns=fns, hs=hs,
                                      ncol=ncol: variant_call(
                                          fns, a, b, ia, ib, vec, hs, ncol)))
                row = {'path': path, 'order': order, 'F': f, 'H': h,
                       'dtype': str(dt).split('.')[-1], 'ms': {}}
                for name, fn in turns + turns[::-1]:
                    row['ms'].setdefault(name, []).append(
                        kernel_ms(torch, fn, 'edge_dot', 10))
                for name, ts in row['ms'].items():
                    log(f"[ab] edge_dot path {path} ({order} order) H*F="
                        f"{h * f} {row['dtype']}: {name}: "
                        + ' / '.join(f'{t:.4f}' for t in ts) + ' ms')
                rows.append(row)
    return rows


# the policy sweep's grid
POLICY_NODES = (1_000, 10_000, 30_000, 100_000)
POLICY_DEGREES = (10, 33, 100)
POLICY_FEATS = (16, 64, 128)
# the dense arms run up to this many entries (30k nodes: 3.6 GB float32)
POLICY_DENSE_ENTRIES = 1.5e9
# the graphs up to this many nodes also time each capturable arm captured
POLICY_CAPTURED_NODES = 10_000
# the arms a captured forward can run (no host sync in the call)
POLICY_CAPTURED_ARMS = ('kernel', 'windowed', 'dense-cached f32',
                        'dense-cached bf16')


def arm_times(torch, fn, iters=20):
    """``(event_ms, device_ms)`` per call of ``fn``: CUDA events over
    ``iters`` back-to-back calls after 3, and ``torch.profiler``'s device
    time (``chip_smoke.device_ms``)."""
    import chip_smoke as cs
    ev, _, _, _ = cs.timed_calls(torch, fn, iters, 3)
    return ev, cs.device_ms(torch, fn, calls=max(iters // 2, 3))


def captured_ms(torch, fn, iters=50):
    """CUDA-event ms per replay of ``fn`` captured in one CUDA graph, after
    3 eager calls on a side stream (the allocator's warm-up) and 3
    replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(3):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def per_window_fn(torch, win, indptr, x, n_dst):
    """The windowed design not taken: kernel 1 once a window, over the
    window's rows, onto the accumulator as ``base`` (a row cut by a
    window's edge gets two partial sums). The windows' row ranges and
    row pointers (cut from ``indptr``, the CSC's, which delimits the
    layout's flat slots) are made here, once, as ``fill_cache`` would."""
    from pytorch_geometric_tpu_torch.ops.segment_spmm import _launch
    n_chunks, c = win.src.shape
    ip = indptr.long().cpu()
    e_real = int(ip[-1])
    dst = win.dst.reshape(-1)[:e_real].cpu()
    src = win.src.reshape(-1)
    plan = []
    for k in range(n_chunks):
        lo, hi = k * c, min((k + 1) * c, e_real)
        if lo >= hi:
            break
        r0, r1 = int(dst[lo]), int(dst[hi - 1])
        sub = (ip[r0:r1 + 2].clamp(lo, hi) - lo).to(torch.int32).to(x.device)
        plan.append((r0, r1, sub, src[lo:lo + c]))

    def run():
        acc = x.new_zeros((n_dst, x.shape[1]))
        for r0, r1, sub, s in plan:
            acc[r0:r1 + 1] = _launch(sub, s, None, x, base=acc[r0:r1 + 1])
        return acc
    return run


def policy_graph(torch, n, deg, seed):
    """A random graph of ``n`` nodes and ``n * deg`` edges: its COO on the
    card and a cached EdgeIndex (CSC and CSR, no slot orders)."""
    from pytorch_geometric_tpu_torch import EdgeIndex
    rng = np.random.default_rng(seed + n + deg)
    coo = rng.integers(0, n, (2, n * deg)).astype(np.int32)
    raw = EdgeIndex(coo, (n, n), device='cuda')
    return raw, raw.fill_cache(blocked=False)


def policy_arms(torch, n, raw, cached, f, dense=True, windowed=None,
                bsr=None):
    """The forward arms at one shape: ``{arm: (event_ms, device_ms)}``,
    plus ``captured_ms`` for the capturable arms up to
    :data:`POLICY_CAPTURED_NODES` nodes; each arm's regime checked."""
    import importlib
    from chip_smoke import knobs
    from pytorch_geometric_tpu_torch.ops import spmm, spmm_regime
    # the module (the package's ``ops.spmm`` names the function)
    sm = importlib.import_module('pytorch_geometric_tpu_torch.ops.spmm')
    x = torch.randn(n, f, device='cuda')
    res, ref = {}, []

    def one(arm, ei, want, env=None, attrs=()):
        with knobs(env, attrs):
            got = spmm_regime(ei, f)
            if got != want:
                raise RuntimeError(f'policy sweep: {arm} ran {got!r}, not '
                                   f'{want!r}')
            with torch.inference_mode():
                out = spmm(ei, x).float()
                if not ref:
                    ref.append(out)
                # float32 sums in another order; the bf16 cache rounds x
                tol = (2e-2 if 'bf16' in arm else 1e-4) * max(
                    1.0, float(ref[0].abs().max()))
                err = float((out - ref[0]).abs().max())
                if err > tol:
                    raise RuntimeError(f'policy sweep: {arm} is {err:.3g} '
                                       f'off the kernel arm (limit {tol:.3g})')
                del out
                res[arm] = arm_times(torch, lambda: spmm(ei, x))
                if (n <= POLICY_CAPTURED_NODES
                        and arm in POLICY_CAPTURED_ARMS):
                    res[arm] = (*res[arm],
                                captured_ms(torch, lambda: spmm(ei, x)))

    # the kernel arms with the chunk trigger lifted (past it the cached CSC
    # and the raw COO would take the chunked regime)
    lifted = {'PGT_SPMM_CHUNK_TRIGGER': 'inf'}
    one('kernel', cached, 'kernel', env=lifted)
    one('kernel uncached', raw, 'kernel', env=lifted)
    one('chunked', raw, 'chunked', env={'PGT_SPMM_CHUNK_TRIGGER': 0})
    if windowed is not None:
        one('windowed', windowed, 'windowed')
    if dense and n * n <= POLICY_DENSE_ENTRIES:
        one('dense', raw, 'dense',
            env={'PGT_FORCE_DENSE_SPMM': 1,
                 'PGT_DENSE_SPMM_ENTRIES': POLICY_DENSE_ENTRIES},
            attrs=[(sm, 'DENSE_ADVANTAGE', float('inf'))])
        ones = torch.ones(raw.num_edges, device='cuda')
        for tag, dt in (('f32', None), ('bf16', torch.bfloat16)):
            with knobs({'PGT_DENSE_SPMM_ENTRIES': POLICY_DENSE_ENTRIES}):
                ei = raw.fill_cache(dense_weight=ones, blocked=False,
                                    cache_dtype=dt)
            one(f'dense-cached {tag}', ei, 'dense-cached')
            del ei
    if bsr is not None:
        one('bsr', bsr, 'bsr')
    torch.cuda.empty_cache()
    return res


def policy_sweep(torch, seed, part='all'):
    """The regime sweep (module docstring): a list of rows, each a graph,
    F and ``{arm: (event_ms, device_ms[, captured_ms])}``; ``part='small'``
    the rows up to :data:`POLICY_CAPTURED_NODES` nodes and the training
    row."""
    import chip_smoke as cs
    from pytorch_geometric_tpu_torch import EdgeIndex
    from pytorch_geometric_tpu_torch.ops import spmm
    rows = []

    def report(graph, f, arms, **info):
        cap = {a: t[2] for a, t in arms.items() if len(t) > 2}
        best = (min(cap, key=cap.get) if cap
                else min(arms, key=lambda a: arms[a][1]))
        eager = min(arms, key=lambda a: arms[a][0])
        log(f'[policy] {graph} F={f}: ' + ', '.join(
            f'{a} {t[0]:.4f} ({t[1]:.4f}'
            + (f', captured {t[2]:.4f})' if len(t) > 2 else ')')
            for a, t in arms.items())
            + f' ms; fastest: {best} (eager: {eager})')
        rows.append(dict(graph=graph, F=f, arms=arms, fastest=best,
                         fastest_eager=eager, **info))

    nodes = [n for n in POLICY_NODES
             if part == 'all' or n <= POLICY_CAPTURED_NODES]
    for n in nodes:
        for deg in POLICY_DEGREES:
            raw, cached = policy_graph(torch, n, deg, seed)
            win = raw.fill_cache(blocked=False, windowed=True)
            for f in POLICY_FEATS:
                report(f'random n={n} deg={deg}', f,
                       policy_arms(torch, n, raw, cached, f, windowed=win),
                       nodes=n, edges=n * deg)
            del raw, cached, win
            torch.cuda.empty_cache()
    # training: forward and backward with weights requiring a gradient
    n, deg, f = 100_000, 100, 64
    raw, cached = policy_graph(torch, n, deg, seed)
    win = raw.fill_cache(blocked=False, windowed=True)
    x = torch.randn(n, f, device='cuda', requires_grad=True)
    w = torch.rand(raw.num_edges, device='cuda', requires_grad=True)
    arms = {}
    for arm, ei, env in (('kernel', cached, {'PGT_SPMM_CHUNK_TRIGGER': 'inf'}),
                         ('windowed', win, {}),
                         ('chunked', raw, {'PGT_SPMM_CHUNK_TRIGGER': 0})):
        with cs.knobs(env):
            def step():
                x.grad = w.grad = None
                spmm(ei, x, w).square().sum().backward()
            arms[arm] = arm_times(torch, step, iters=10)
    report(f'training n={n} deg={deg} (x and w need gradients)', f, arms,
           nodes=n, edges=n * deg)
    del raw, cached, win, x, w
    torch.cuda.empty_cache()
    if part == 'small':
        return rows
    # path A's clustered graph, with the block cache
    coo, _, _ = cs.path_a_graph(seed)
    n = cs.PA_NODES
    raw = EdgeIndex(coo, (n, n), device='cuda')
    cached = raw.fill_cache(blocked=False)
    win = raw.fill_cache(blocked=False, windowed=True)
    ones = torch.ones(raw.num_edges, device='cuda')
    bsr = raw.fill_cache(dense_weight=ones, blocked=False, block_sparse=True)
    auto = raw.fill_cache(auto=True)
    from pytorch_geometric_tpu_torch.ops import spmm_regime
    report('path A clustered', cs.TR_F,
           policy_arms(torch, n, raw, cached, cs.TR_F, dense=False,
                       windowed=win, bsr=bsr),
           nodes=n, edges=raw.num_edges,
           auto_regime=spmm_regime(auto, cs.TR_F))
    del raw, cached, win, bsr, auto, ones
    torch.cuda.empty_cache()
    # the products-like graph
    t0 = time.perf_counter()
    coo = cs.products_graph(cs.N_PRODUCTS, cs.E_PRODUCTS, seed)
    log(f'[policy] products graph on the host in '
        f'{time.perf_counter() - t0:.1f} s')
    n = cs.N_PRODUCTS
    raw = EdgeIndex(coo, (n, n), device='cuda')
    del coo
    builds = {}

    def built(tag, fn):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        builds[tag] = {'s': time.perf_counter() - t,
                       'gb': (torch.cuda.memory_allocated() - m0) / 1e9,
                       'peak_gb': (torch.cuda.max_memory_allocated()
                                   - m0) / 1e9}
        log(f'[policy] products {tag}: {builds[tag]["s"]:.3f} s, '
            f'{builds[tag]["gb"]:.3f} GB kept, peak '
            f'{builds[tag]["peak_gb"]:.3f} GB over the COO')
        return out

    cached = built('CSC and CSR', lambda: raw.fill_cache(blocked=False))
    win = built('CSC and CSR with the windowed layouts',
                lambda: raw.fill_cache(blocked=False, windowed=True))
    slots = built('CSC and CSR with the slot orders',
                  lambda: raw.fill_cache(blocked=True))
    del slots
    torch.cuda.empty_cache()
    for f in (cs.PR_F, cs.PR_HIDDEN):
        arms = policy_arms(torch, n, raw, cached, f, dense=False,
                           windowed=win)
        x = torch.randn(n, f, device='cuda')
        with torch.inference_mode():
            run = per_window_fn(torch, win.win, win.csc.indptr, x, n)
            err = float((run() - spmm(win, x)).abs().max())
            if err > 1e-4 * max(1.0, float(x.abs().max()) * 50):
                raise RuntimeError(f'policy sweep: the per-window pass is '
                                   f'{err:.3g} off the one-launch pass')
            arms['windowed per window'] = arm_times(torch, run, iters=5)
        report('products', f, arms, nodes=n, edges=raw.num_edges,
               builds=builds)
        del x
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--parent', type=Path, default=None)
    ap.add_argument('--only', choices=('flash', 'dot', 'policy'),
                    default=None)
    ap.add_argument('--policy-part', choices=('all', 'small'), default='all')
    ap.add_argument('--out', type=Path, default=None)
    ap.add_argument('--dot-variant', action='append', default=[],
                    metavar='NAME=PATH',
                    help='a copy of csrc/sddmm.cu (with vec.cuh beside it) '
                         'to time beside the package\'s dot kernel at each '
                         'shape and slice shape')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        log('kernel_ab: no CUDA card is visible')
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pytorch_geometric_tpu_torch import csrc
    smi = cs.phase_device(torch)
    if args.only == 'policy':
        csrc.build_all(['segment_spmm', 'sddmm', 'bsr_spmm'])
        res = {'device': torch.cuda.get_device_name(0), 'nvidia_smi': smi,
               'policy': policy_sweep(torch, args.seed, args.policy_part)}
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(res, indent=1))
        log(json.dumps({'kernel_ab': 'done', 'device': res['device']}))
        return 0
    csrc.build_all(['flash_softmax', 'sddmm'])
    AB_DIR.mkdir(parents=True, exist_ok=True)
    src = (csrc.SOURCE_DIR / 'flash_softmax.cu').read_text()
    (AB_DIR / 'flash_ab.cu').write_text(ab_source(src))
    jobs = {}
    if args.only != 'dot':
        jobs['ab'] = (AB_DIR / 'flash_ab.cu', AB_DIR / 'libflash_ab.so')
    if args.parent is not None:
        par = AB_DIR / 'parent'
        par.mkdir(exist_ok=True)
        for name in ('flash_softmax.cu', 'sddmm.cu', 'vec.cuh'):
            shutil.copy(args.parent / name, par / name)
        if args.only != 'dot':
            jobs['parent_flash'] = (par / 'flash_softmax.cu',
                                    par / 'libflash_parent.so')
        if args.only != 'flash':
            jobs['parent_dot'] = (par / 'sddmm.cu',
                                  par / 'libsddmm_parent.so')
    for spec in args.dot_variant:
        name, path = spec.split('=', 1)
        jobs[f'dot {name}'] = (Path(path), AB_DIR / f'libsddmm_{name}.so')
    libs = build(jobs)
    res = {'device': torch.cuda.get_device_name(0)}
    if args.only != 'dot':
        res['flash_fwd'] = flash_ab(torch, libs, args.seed,
                                    args.parent is not None)
        torch.cuda.empty_cache()
    if args.parent is not None and args.only != 'flash':
        res['edge_dot'] = dot_ab(torch, libs, args.seed, True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    log(json.dumps({'kernel_ab': 'done', 'device': res['device']}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
