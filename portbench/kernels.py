"""The yardstick of the port's kernels: published peaks, and the launches,
operations and bytes of K3, K4, K6, K7 and K8 at a cell's shapes.

The arithmetic is that of the program's smoke run (``chip_smoke.py``:
``bound``, ``_k8_shape`` and the entries of ``check_kernels``), kept here
so that a later change to the program cannot change how its kernels are
judged.  Bytes count each input once and each output once; operations
are float32 FMA-pipe operations (K8 computes bfloat16 operands in float32
chains too).  A launch's least time is the larger of its operations over
the float32 peak and its bytes over the memory bandwidth.

K4's operations leave out its CDF evaluations (their number follows each
symbol's row, which the harness does not see), so its least time is a
lower bound, as is every share of a roofline computed from it.
"""

from __future__ import annotations

# Published NVIDIA H100 SXM peaks, dense, at the full 700 W limit.
HBM_BPS = 3.35e12
F32_OPS = 67e12
BF16_OPS = 989e12
CDF_OPS = 36          # operations of one Gaussian CDF evaluation (K7)

# substrings of the kernels' names in a device trace
K8_NAME = "invariant_matmul_kernel"
RANS_NAMES = {"rans_encode_prep": "rans_encode_prep_kernel",
              "rans_encode_scan": "rans_encode_kernel",
              "rans_encode_compact": "rans_compact_kernel",
              "rans_decode_phase": "rans_decode_kernel"}


def least_s(nbytes: float, ops: float, peak_ops: float = F32_OPS) -> float:
    """The least time of a launch, in seconds."""
    return max(nbytes / HBM_BPS, ops / peak_ops)


def _problem(groups, m, n, k, a_elems, b_elems, bias, es, name):
    """One K8 launch: ``groups`` problems of m x n x k, its operands of
    ``a_elems`` and ``b_elems`` elements of ``es`` bytes, the output once,
    the bias (n elements) where there is one."""
    nbytes = (a_elems + b_elems + groups * m * n + (n if bias else 0)) * es
    return {"name": name, "groups": groups, "mnk": (m, n, k),
            "bytes": nbytes, "ops": 2.0 * groups * m * n * k}


def k8_problems(model: dict, batch: int, height: int, width: int,
                direction: str) -> list:
    """K8's launches in one ``direction`` ("compress" or "decompress") of
    a batch of a depthwise MLIC++ (``model``: N, M, slice_num): in the
    compress, g_a's two 1x1 convolutions over the image's three channels
    (bfloat16), then in both directions each slice's window fusion and,
    from the second slice on, the inter and intra contexts' two
    contractions and 5x5 reprojection (float32)."""
    if not model.get("depthwise", True):
        raise ValueError("k8_problems: depthwise configurations only")
    N, M, S = int(model["N"]), int(model["M"]), int(model["slice_num"])
    C, B = M // S, batch
    h, w = height // 16, width // 16
    L = h * w
    out = []
    if direction == "compress":
        m = (height // 2) * (width // 2)
        for name in ("g_a.rbs0.skip", "g_a.rbs0.conv1.dw.point"):
            out.append(_problem(B, m, N, 3, B * 3 * m, N * 3, True, 2, name))
    elif direction != "decompress":
        raise ValueError(f"unknown direction {direction!r}")
    for i in range(S):
        for ctx in ("ginter", "local", "gintra"):      # the calls' order
            if ctx == "local":
                out.append(_problem(B, L, 2 * C, 25 * C, B * L * 25 * C,
                                    2 * C * 25 * C, True, 4,
                                    f"local_{i}.fusion"))
                continue
            if i == 0:
                continue
            dim, heads, n_tok, mid = ((C * i, max(C * i // 32, 1), L, 3 * C)
                                      if ctx == "ginter" else
                                      (C, 2, L // 2, 2 * C))
            hd = dim // heads
            g = B * heads
            out.append(_problem(g, hd, hd, n_tok, B * n_tok * dim,
                                B * n_tok * dim, False, 4,
                                f"{ctx}_{i}.kt_v"))
            out.append(_problem(g, n_tok, hd, hd, B * heads * hd * hd,
                                B * n_tok * dim, False, 4,
                                f"{ctx}_{i}.ctx_q"))
            out.append(_problem(B, L, mid, 25 * dim, B * dim * L,
                                mid * 25 * dim, True, 4,
                                f"{ctx}_{i}.reprojection"))
    return out


def rans_geometry(model: dict, batch: int, height: int, width: int,
                  lanes: int) -> dict:
    """The position layout of a batch's format-v4 streams: symbols of z
    and of one y phase an image, steps of each, all steps."""
    N, M, S = int(model["N"]), int(model["M"]), int(model["slice_num"])
    n_z = N * (height // 64) * (width // 64)
    n_y = M * (height // 16) * (width // 16)
    n_per = n_y // (2 * S)
    sz, sp = -(-n_z // lanes), -(-n_per // lanes)
    return {"n_z": n_z, "n_y": n_y, "n_per": n_per, "z_steps": sz,
            "phase_steps": sp, "steps": sz + 2 * S * sp, "phases": 2 * S,
            "L": batch * lanes, "W": -(-lanes // 32), "B": batch}


def rans_launches(model: dict, batch: int, height: int, width: int,
                  lanes: int, words: int, escapes: int) -> list:
    """The rANS kernels' launches of one round trip of a batch: the
    encode's K7, K3 and K6, and K4 once for z and once a y phase.
    ``words`` and ``escapes`` are the batch's totals from the streams'
    headers (the words hold each lane's two state words).  Returns
    [(kernel, bytes, operations)]."""
    g = rans_geometry(model, batch, height, width, lanes)
    B, L, W, S = g["B"], g["L"], g["W"], g["steps"]
    n_yt, n_zt = B * g["n_y"], B * g["n_z"]
    n_real = n_yt + n_zt
    out = [("rans_encode_prep", 17 * n_yt + 13 * n_zt,
            2.0 * n_yt * CDF_OPS),
           ("rans_encode_scan", 8 * n_real + 2 * S * L + 4 * S * B * W
            + 8 * L, 10.0 * S * L),
           ("rans_encode_compact", 4 * S * B * W + 2 * (words - 2 * L)
            + n_real + 4 * escapes + 8 * L + 2 * words + 4 * escapes
            + 8 * B, 0.0)]
    consumed = words - 2 * L
    for k in range(1 + g["phases"]):
        P = (g["z_steps"] if k == 0 else g["phase_steps"]) * L
        share = consumed if k == 0 else 0      # all words in one launch:
        # every K4 launch is bound by its bytes, so where they fall does
        # not change the sum of least times
        out.append(("rans_decode_phase", 9 * P + 2 * share + 16 * L + 8 * B,
                    20.0 * P))
    return out


RANS_ENCODE = ("rans_encode_prep", "rans_encode_scan", "rans_encode_compact")


def k8_share(obs: dict, directions: tuple, within: str | None = None):
    """K8's share (%) of its roofline over a traced stretch (the
    per-layer readers' ``obs``): the least time of its launches in
    ``directions`` for every batch of the stretch, over the device time of
    its launches (those that began inside ``within`` calls, where given);
    None where there is none."""
    mix, model = obs["mix"], obs["config"]["model"]
    shape = (int(mix["batch"]), int(mix["height"]), int(mix["width"]))
    secs, n = obs["trace"].ops_s(K8_NAME, within)
    if not n:
        return None
    least = obs["batches"] * sum(least_s(p["bytes"], p["ops"])
                                 for d in directions
                                 for p in k8_problems(model, *shape, d))
    return 100.0 * least / secs


def rans_share(obs: dict, kernels: tuple, within: str | None = None):
    """The share (%) of the rANS ``kernels`` (names of ``RANS_NAMES``) of
    their roofline over a traced stretch: the least time of their launches
    for every batch, from its coded words and escapes, over the device time
    of their launches (those that began inside ``within`` calls, where
    given); None where there is none."""
    mix, model = obs["mix"], obs["config"]["model"]
    shape = (int(mix["batch"]), int(mix["height"]), int(mix["width"]),
             int(obs["config"]["lanes"]))
    least = sum(least_s(nb, ops)
                for w, e in zip(obs["words"], obs["escapes"])
                for k, nb, ops in rans_launches(model, *shape, w, e)
                if k in kernels)
    secs = n = 0
    for k in kernels:
        s, c = obs["trace"].ops_s(RANS_NAMES[k], within)
        secs, n = secs + s, n + c
    if not n:
        return None
    return 100.0 * least / secs


def flops(obs: dict) -> dict:
    """The reference's operations at the cell's shapes (``count_flops``),
    counted once a traced run."""
    if "flops" not in obs:
        mix = obs["mix"]
        obs["flops"] = obs["reference"]().count_flops(
            int(mix["batch"]), int(mix["height"]), int(mix["width"]))
    return obs["flops"]
