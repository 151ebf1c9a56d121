"""The layers' bf16 instances (rows 1, 4, 11, 12 at the mLstm training
shape, rows 7, 8, 13 at the mGru one) and the scans' chains (rows 15 and
17 at the same shapes, without iW) with their f32 rows, timed with CUDA
events: to hold two checkouts' times side by side in one call on one
card, where a change to the shared kernel templates may move the layers'
instances.  Every stream bf16 but the f32 carry (the later layer's case
of chip_smoke.py's phases 16a and 17a; the scans' default case of phase
19a: gates_x, residuals and dh bf16, h f32); inputs seeded, residuals
from the checkout's own forwards.  Only csrc/lstm.cu and csrc/gru.cu are
built.

From the root of each checkout, on the card (run the same probe file in
both: it imports the checkout it runs in):

    python3 probes/layer_bf16_times.py --tag change
    (cd other_checkout && python3 /path/to/probes/layer_bf16_times.py \\
        --tag parent)

Prints one line "PTXAS <json>": [{"kernel", "args" (its template
arguments), "registers", "spill_stores", "spill_loads", "stack"}] of every
instance of the backward chains' cluster kernels in the build's report
(<library>.log, nvcc -Xptxas -v), and one line "TIMES <json>": {"tag",
"card", "ms": {row: median of ROUNDS rounds of REPS calls}, "spread"}.
"""

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np

T_LSTM, T_GRU, B, H = 800, 2000, 256, 256
ROUNDS, REPS = 5, 5


def cuda_ms(torch, fn, reps):
    """Mean device time of fn() over `reps` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cases(torch, dev):
    """{row name: a call of its wrapper} for the bf16 and f32 instances."""
    from taiyaki_tpu_torch.ops import gru, lstm
    bf = torch.bfloat16
    rng = np.random.default_rng(1)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(
            np.float32)).to(dev)
    out = {}
    for dt, tag in ((bf, "[bf16]"), (torch.float32, "")):
        kw = dict(h_dtype=dt, res_dtype=dt) if dt == bf else {}
        x, iW, b = t(T_LSTM, B, H), t(4 * H, H, scale=H ** -0.5), t(4 * H)
        sW, dh = t(4 * H, H, scale=H ** -0.5), t(T_LSTM, B, H)
        x, dh = x.to(dt), dh.to(dt)
        h, c, acts, tc = lstm.lstm_fwd(x, iW, b, sW, emit="acts", **kw)
        pre = lstm.lstm_fwd(x, iW, b, sW, emit="pre", **kw)[2]
        cp = lstm.prev_state(c, False)
        out.update({
            "lstm_fwd" + tag: (lambda x=x, iW=iW, b=b, sW=sW, kw=kw:
                               lstm.lstm_fwd(x, iW, b, sW, emit="acts",
                                             **kw)),
            "lstm_bwd_acts" + tag: (lambda a=(dh, acts, tc, cp, h, x, sW,
                                              iW): lstm.lstm_bwd_acts(*a)),
            "lstm_bwd_fusedw" + tag: (lambda a=(dh, pre, c, cp, h, x, sW,
                                                iW): lstm.lstm_bwd_fusedw(
                                                    *a)),
            "lstm_bwd_recompute" + tag: (
                lambda a=(dh, c, h, x, sW, iW, b): lstm.lstm_bwd_recompute(
                    *a))})
        x, iW, b = t(T_GRU, B, H), t(3 * H, H, scale=H ** -0.5), t(3 * H)
        sW, dh = t(3 * H, H, scale=H ** -0.5), t(T_GRU, B, H)
        x, dh = x.to(dt), dh.to(dt)
        h, gh, gx = gru.gru_fwd(x, iW, b, sW, emit_residuals=True, **kw)
        hp = lstm.prev_state(h, False)
        out.update({
            "gru_fwd" + tag: (lambda x=x, iW=iW, b=b, sW=sW, kw=kw:
                              gru.gru_fwd(x, iW, b, sW, **kw)),
            "gru_bwd_recompute" + tag: (
                lambda a=(dh, h, x, sW, iW, b): gru.gru_bwd_recompute(*a)),
            "gru_bwd_fusedw" + tag: (
                lambda a=(dh, gx, gh, hp, x, sW, iW): gru.gru_bwd_fusedw(
                    *a))})
    # the scans' chains (rows 15, 17): their forwards' residuals from gates
    # of the scans' dtype
    for dt, tag in ((bf, "[bf16]"), (torch.float32, "")):
        kw = dict(res_dtype=dt) if dt == bf else {}
        for cell, G, T, mod in (("lstm", 4, T_LSTM, lstm),
                                ("gru", 3, T_GRU, gru)):
            g = t(T, B, G * H).to(dt)
            sW, dh = t(G * H, H, scale=H ** -0.5), t(T, B, H).to(dt)
            res = getattr(mod, cell + "_scan_fwd")(g, sW, residuals=True,
                                                   **kw)
            if cell == "lstm":
                _, c, pre = res
                args = (dh, pre, c, lstm.prev_state(c, False), sW)
            else:
                hs, ghs = res
                args = (dh, g, ghs, lstm.prev_state(hs, False), sW)
            out[cell + "_scan_bwd" + tag] = (
                lambda f=getattr(mod, cell + "_scan_bwd"), a=args: f(*a))
    return out


def ptxas_report(cuda_lib):
    """The registers, spill bytes and stack frame of every instance of the
    backward chains' cluster kernels, from the build's report of
    csrc/lstm.cu and csrc/gru.cu (names demangled by cu++filt or
    c++filt where the machine has one)."""
    props = {}
    for lib in ("lstm", "gru"):
        name = None
        with open(cuda_lib._target(lib)[1] + ".log") as fh:
            for line in fh:
                m = re.search(r"Function properties for (\S+)", line)
                if m:
                    name = m.group(1)
                    props.setdefault(name, {})
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
                if m and name:
                    props[name].update(stack=int(m.group(1)),
                                       spill_stores=int(m.group(2)),
                                       spill_loads=int(m.group(3)))
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    props[name]["registers"] = int(m.group(1))
    names = [n for n in props if "bwd_rec_cluster_kernel" in n]
    filt = next((p for p in (os.path.join(os.path.dirname(cuda_lib._nvcc()),
                                          "cu++filt"),
                             shutil.which("cu++filt"), shutil.which("c++filt"))
                 if p and os.path.isfile(p)), None)
    plain = names
    if filt:
        plain = subprocess.run([filt], input="\n".join(names),
                               capture_output=True, text=True,
                               check=False).stdout.split("\n")[:len(names)]
    rows = []
    for mangled, readable in zip(names, plain):
        m = re.search(r"(\w+_bwd_rec_cluster_kernel)<(.*?)>\(", readable)
        rows.append(dict(kernel=m.group(1) if m else mangled,
                         args=m.group(2) if m else "", **props[mangled]))
    return sorted(rows, key=lambda r: (r["kernel"], r["args"]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default=os.path.basename(os.getcwd()))
    args = ap.parse_args()
    import torch
    sys.path.insert(0, os.getcwd())
    from taiyaki_tpu_torch.ops import cuda_lib
    cuda_lib.SOURCES = ("lstm", "gru")
    cuda_lib.build_all()
    print("PTXAS " + json.dumps(ptxas_report(cuda_lib)), flush=True)
    dev = torch.device("cuda", 0)
    fns = cases(torch, dev)
    times = {k: [] for k in fns}
    for _ in range(ROUNDS):
        for k, fn in fns.items():
            times[k].append(cuda_ms(torch, fn, REPS))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print("TIMES " + json.dumps({
        "tag": args.tag, "card": card,
        "ms": {k: round(statistics.median(v), 4) for k, v in times.items()},
        "spread": {k: round(max(v) - min(v), 4) for k, v in times.items()}}),
        flush=True)


if __name__ == "__main__":
    main()
