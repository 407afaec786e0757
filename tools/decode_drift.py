#!/usr/bin/env python3
"""How far a decode step drifts from the prefill, layer by layer, in a
random model at full width on one NVIDIA GPU.

    python3 tools/decode_drift.py [--arch qwen2-vl-2b] [--batch 4] [--seq 2048]
    python3 tools/decode_drift.py --arch whisper-medium --batch 8 --seq 32 --whole --parity
    python3 tools/decode_drift.py --arch whisper-medium --batch 1 --seq 32 --frames 4096 --walk

Draws the config's weights from a torch.Generator seeded 0 on the card and
N(0, 0.1²) bf16 embeddings (Qwen2-VL; its M-RoPE ids laid out as in
``chip_smoke.py`` phase 5e: 16 text tokens, a 32 x 32 grid, text) or frames
and tokens (Whisper, ``--seq`` decoder tokens over ``--frames`` frames,
1500 unless given).  Runs the
decoder blocks two ways: a prefill over S+1 positions, and a prefill over S
followed by one decode step at position S, each fed its own previous
output.  Prints, after every block, the decode step's hidden state against
the prefill's row S over its scale, with the attention kernel and with its
plain version on the card, and with M-RoPE and plain RoPE (Qwen2-VL).  A
model whose error is ~1e-3 after the first block and O(1) after the last is
chaotic, not wrong: ``chip_smoke.py``'s block walk holds each block alone.
Also prints layer 0's score spread and top-2 score gaps at position S.
``--whole`` also runs the whole model through ``make_prefill_step`` /
``make_decode_step`` and prints the first decode step's logits against the
last logits of a prefill over S+1 (the reference's
``tests/test_models.py:70-88`` check, which the chaos above defeats at full
width).  ``--parity`` runs the reduced model (Qwen2-VL at 12/2 heads) on the
card and on the CPU, from the same weights, through the steps (a prefill
over 40 positions and 4 decode steps) and prints the worst logits error
over their scale, with the attention kernel and with its plain version on
the card.  ``--walk`` runs ``chip_smoke.py``'s block walk (each block held
alone: the decode step at position S on the block's own prefill cache
against the prefill's row S) with the kernel and with the plain attention,
and prints each decoder block's reading: where the walk's error comes from.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def drift(cfg, params, batch, S, dev, mrope=True):
    """Per decoder block: the free-running decode step's hidden state at
    position S against the free-running prefill's row S, over its scale."""
    import dataclasses
    import torch
    import chip_smoke as cs
    from repro_torch.models import lm as L
    from repro_torch.models.layers import apply_norm, embed
    cfg = dataclasses.replace(cfg, cache_len=S + 1)
    enc_out, mr = None, batch.get("mrope_positions") if mrope else None
    if cfg.family == "encdec":
        x = batch["frames"]
        B, Se = x.shape[:2]
        pos = torch.arange(Se, device=dev)[None].expand(B, Se)
        for pl in L._layers(params["stacks"]["enc"]):
            x, _, _ = L.apply_block("enc", x, pl, cfg, positions=pos)
        enc_out = apply_norm(x, params["enc_norm"], cfg.norm)
        full, kind = embed(batch["tokens"], params["embed"]), "dec"
    else:
        full, kind = batch["embeds"], "dense"
    B = full.shape[0]
    pos_f = torch.arange(S + 1, device=dev)[None].expand(B, S + 1)
    pos_p = pos_f[:, :S]
    pos_d = torch.full((B, 1), S, dtype=torch.int32, device=dev)
    a, b, c, out = full, full[:, :S], full[:, S:S + 1], []
    for pl in L._layers(params["stacks"][kind]):
        a, _, _ = L.apply_block(kind, a, pl, cfg, cache="init",
                                positions=pos_f, enc_out=enc_out,
                                mrope_positions=None if mr is None
                                else mr[:, :, :S + 1])
        b, cache, _ = L.apply_block(kind, b, pl, cfg, cache="init",
                                    positions=pos_p, enc_out=enc_out,
                                    mrope_positions=None if mr is None
                                    else mr[:, :, :S])
        c, _, _ = L.apply_block(kind, c, pl, cfg, cache=cache,
                                positions=pos_d, pos_offset=pos_d[:, 0],
                                enc_out=enc_out,
                                mrope_positions=None if mr is None
                                else mr[:, :, S:S + 1])
        out.append(round(cs.scale_err(c[:, 0], a[:, -1]), 4))
    return out


def whole(cfg, params, batch, S, dev) -> float:
    """The whole model's first decode step at position S against the last
    logits of a prefill over S+1, over their scale."""
    import torch
    import chip_smoke as cs
    from repro_torch.core.plan import single_device_plan
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    plan = single_device_plan(str(dev))
    cache = cs.WHISPER_CACHE if cfg.family == "encdec" else cs.SERVE_CACHE
    prefill = make_prefill_step(cfg, plan, cache)
    decode = make_decode_step(cfg, plan, cache)
    part = {k: (v[:, :, :S] if k == "mrope_positions" else
                v if k == "frames" else v[:, :S]) for k, v in batch.items()}
    full, _ = prefill(params, batch)
    _, caches = prefill(params, part)
    B = full.shape[0]
    step = {"token": batch["tokens"][:, S:S + 1] if "tokens" in batch else
            torch.zeros(B, 1, dtype=torch.int32, device=dev),
            "pos": torch.full((B,), S, dtype=torch.int32, device=dev)}
    if "embeds" in batch:
        step.update(embeds=batch["embeds"][:, S:S + 1],
                    mrope_positions=batch["mrope_positions"][:, :, S:S + 1])
    _, logits, _ = decode(params, caches, step)
    return cs.scale_err(logits[:, -1], full[:, -1])


def parity(arch: str, dev) -> tuple:
    """Reduced ``arch`` through the steps on the card and on the CPU: the
    worst logits error over their scale, with the attention kernel and with
    its plain version on the card."""
    import dataclasses
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.core.plan import single_device_plan
    from repro_torch.core.tree import tree_map
    from repro_torch.models.lm import LM
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    cfg = get(arch).reduced()
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, n_heads=cs.PARITY_VLM_HEADS)
    params = LM(cfg).init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    B, S, cpu = 2, cs.PARITY_S, torch.device("cpu")
    tokens = torch.randint(0, cfg.vocab, (B, S + 4), generator=g,
                           dtype=torch.int32)
    steps = [{"token": tokens[:, S + i:S + i + 1],
              "pos": torch.full((B,), S + i, dtype=torch.int32)}
             for i in range(4)]
    if cfg.family == "encdec":
        batch = {"frames": (torch.randn(B, 48, cfg.d_model, generator=g)
                            * 0.1).to(torch.bfloat16),
                 "tokens": tokens[:, :S]}
    else:
        e = (torch.randn(B, S + 4, cfg.d_model, generator=g)
             * 0.1).to(torch.bfloat16)
        ids, _ = cs.mrope_ids(B, S + 4, *cs.PARITY_GRID, cpu)
        batch = {"embeds": e[:, :S], "mrope_positions": ids[:, :, :S]}
        for i, st in enumerate(steps):
            st.update(embeds=e[:, S + i:S + i + 1],
                      mrope_positions=ids[:, :, S + i:S + i + 1])

    def run(device):
        plan = single_device_plan(str(device))
        p = tree_map(lambda t: t.to(device), params)
        logits, caches = make_prefill_step(cfg, plan, 64)(p, tree_map(
            lambda t: t.to(device), batch))
        out = [logits]
        decode = make_decode_step(cfg, plan, 64)
        for st in steps:
            _, lg, caches = decode(p, caches, tree_map(
                lambda t: t.to(device), st))
            out.append(lg)
        return [t.float().cpu() for t in out]
    with torch.no_grad():
        plain = run(cpu)
        kernel = max(cs.scale_err(a, b) for a, b in zip(run(dev), plain))
        with cs.plain_attention():
            control = max(cs.scale_err(a, b) for a, b in zip(run(dev),
                                                             plain))
    return kernel, control


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-vl-2b",
                    choices=["qwen2-vl-2b", "whisper-medium"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--whole", action="store_true")
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--walk", action="store_true")
    ap.add_argument("--frames", type=int, default=1500)
    args = ap.parse_args()
    import subprocess
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.models.layers import apply_norm, einsum
    from repro_torch.runtime.steps import make_model
    if not torch.cuda.is_available():
        print("decode_drift: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get(args.arch)
    B, S = args.batch, args.seq
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        params = make_model(cfg).init(
            torch.Generator(device=dev).manual_seed(0))
        if cfg.family == "encdec":
            batch = {"frames": (torch.randn(B, args.frames, cfg.d_model,
                                            generator=g, device=dev) * 0.1)
                     .to(torch.bfloat16),
                     "tokens": torch.randint(0, cfg.vocab, (B, S + 1),
                                             generator=g, device=dev,
                                             dtype=torch.int32)}
        else:
            batch = {"embeds": (torch.randn(B, S + 1, cfg.d_model,
                                            generator=g, device=dev) * 0.1)
                     .to(torch.bfloat16),
                     "mrope_positions": cs.mrope_ids(B, S + 1, 16, 32, 32,
                                                     dev)[0]}
        ropes = (True, False) if cfg.mrope else (False,)
        for attention in ("kernel", "plain"):
            for mrope in ropes:
                if attention == "plain":
                    with cs.plain_attention():
                        r = drift(cfg, params, batch, S, dev, mrope)
                else:
                    r = drift(cfg, params, batch, S, dev, mrope)
                print(f"[drift] {cfg.name} B{B} S{S} attention {attention}"
                      + (f", M-RoPE {mrope}" if cfg.mrope else "")
                      + f": per block, the decode step's hidden state "
                      f"against the prefill's row S over its scale {r}",
                      flush=True)
        if args.walk:
            for attention in ("kernel", "plain"):
                if attention == "plain":
                    with cs.plain_attention():
                        w = cs.block_walk(cfg, params, batch, S, dev)
                else:
                    w = cs.block_walk(cfg, params, batch, S, dev)
                per = [round(cs.scale_err(d[:, 0], pre[:, S]), 4)
                       for pre, d in zip(w["prefill"], w["decode"])
                       if d is not None]
                err, at = cs.walk_decode_err(w, S)
                print(f"[drift] {cfg.name} B{B} S{S} block walk, attention "
                      f"{attention}: worst {err:.4f} at {at}; per decoder "
                      f"block {per}; logits "
                      f"{cs.scale_err(w['logits'][1], w['logits'][0]):.4f}",
                      flush=True)
                del w
        if args.whole:
            print(f"[drift] {cfg.name} B{B} S{S}: the whole model's decode "
                  f"step at position S against a prefill over S+1, logits "
                  f"over their scale "
                  f"{whole(cfg, params, batch, S, dev):.4f}", flush=True)
        if cfg.family != "encdec":
            pl = {k: v[0] for k, v in params["stacks"]["dense"]["attn"]
                  .items()}
            ln = {"w": params["stacks"]["dense"]["ln1"]["w"][0]}
            xn = apply_norm(batch["embeds"], ln, cfg.norm)
            q = einsum("bsd,dhk->bshk", xn, pl["wq"]).float()
            k = einsum("bsd,dhk->bshk", xn, pl["wk"]).float()
            group = cfg.n_heads // cfg.n_kv_heads
            s = torch.einsum("bhd,bkd->bhk", q[:, S, :group], k[:, :, 0]) \
                / cfg.head_dim ** 0.5
            top = s.topk(2, -1).values
            gaps = sorted(round(x, 2) for x in
                          (top[..., 0] - top[..., 1]).flatten().tolist())
            print(f"[drift] layer 0, position S, KV head 0's {group} query "
                  f"heads (before rotation): q rms "
                  f"{q.pow(2).mean().sqrt():.2f}, k rms "
                  f"{k.pow(2).mean().sqrt():.2f}, score std {s.std():.2f}, "
                  f"top-2 gaps {gaps}")
    if args.parity:
        del params
        torch.cuda.empty_cache()
        kernel, control = parity(args.arch, dev)
        print(f"[drift] reduced {args.arch}: card against CPU through the "
              f"steps (prefill over {cs.PARITY_S} positions, 4 decode "
              f"steps), logits over their scale {kernel:.4f} with the "
              f"attention kernel, {control:.4f} with its plain version on "
              f"the card", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
