"""Probes behind two numerical choices of the PyTorch port (PERF.md §6).

``JAX_PLATFORMS=cpu python3 tools/port_numerics_probe.py variance`` (CPU;
imports JAX): the BYOL step's parameter updates after two Adam steps
against JAX's, as ``tests/test_torch_train_step.py`` holds them (within
1e-4 of their scale), with the plain LayerNorm statistics of K6 and K7
(``pallas_norm.row_stats``) taken several ways.

``python3 tools/port_numerics_probe.py gradients`` (one H100): the SER
fine-tune step's bf16 gradient against float32 at batch 2 (seeded weights
and batch, as ``chip_smoke.phase_ft_crosscheck`` draws them): with K6
replaced by its plain version on the card, x̂ and dz in bf16 as K6 keeps
them or in float32; then, module by module, how far the bf16 forward and
the gradient arriving at each module are from float32's, beside a float32
run whose input is scaled by 1 + 2⁻¹⁶ noise.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def variance() -> None:
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_train_step as T
    from nrse_tpu_torch.models.convert import byol_variables_to_state_dicts
    from nrse_tpu_torch.ops import fused_frontend, pallas_norm

    two = pallas_norm.row_stats

    def fast(x, eps, acc=torch.float32):
        x = x.to(acc)
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0)
        return mean.float(), torch.rsqrt(var + eps).float()

    def var_mean(x, eps):
        var, mean = torch.var_mean(x, -1, unbiased=False, keepdim=True)
        return mean, torch.rsqrt(var + eps)

    def scaled(f):
        def stats(x, eps):
            mean, rstd = two(x, eps)
            return mean, rstd * f
        return stats

    ways = {"two passes (the plain versions)": two,
            "fast variance": fast,
            "fast variance, float64 sums": lambda x, e: fast(x, e,
                                                             torch.float64),
            "torch.var_mean": var_mean,
            "two passes, rstd x (1 + 2^-23)": scaled(1 + 2.0 ** -23),
            "two passes, rstd x (1 - 2^-23)": scaled(1 - 2.0 ** -23)}
    for name, stats in ways.items():
        pallas_norm.row_stats = fused_frontend.row_stats = stats
        start, end, _, _, online0, pstate, _, _, cfg = T._runs(False)
        want, _ = byol_variables_to_state_dicts(end, cfg)
        got = {k: v.detach().numpy()
               for k, v in pstate.online.state_dict().items()}
        pairs = {k: (got[k] - online0[k], w - online0[k])
                 for k, w in want.items() if "running" not in k}
        scale = max(np.abs(r).max() for _, r in pairs.values())
        err, key = max((float(np.abs(g - r).max()) / scale, k)
                       for k, (g, r) in pairs.items())
        print(f"{name}: updates within {err:.2e} of JAX's scale ({key})",
              flush=True)
    pallas_norm.row_stats = fused_frontend.row_stats = two


def gradients(seeds=(13, 21, 22, 23, 24, 25, 31)) -> None:
    import torch.nn.functional as F

    import chip_smoke as c
    from nrse_tpu_torch.baseline import train_ft_cat_ser
    from nrse_tpu_torch.models.wavlm import TrainRNG, WavLMConfig
    from nrse_tpu_torch.ops import fused_frontend as FF

    c.phase_device()
    c.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    quiet = dict(hidden_dropout=0.0, activation_dropout=0.0,
                 attention_dropout=0.0, layerdrop=0.0, mask_time_prob=0.0)

    def step(cfg, data, device, seed, watch=()):
        state = c._ft_state(cfg, device, c.SEED + seed, dropout=0.0)
        acts, grads = {}, {}
        mods = dict(state.model.named_modules())
        for n in watch:
            def hook(m, i, out, n=n):
                o = out[0] if isinstance(out, tuple) else out
                acts[n] = o.detach().double().cpu()
                o.register_hook(lambda g: grads.__setitem__(
                    n, g.detach().double().cpu()))
            mods[n].register_forward_hook(hook)
        run = train_ft_cat_ser.make_train_step(  # eager: the hooks fire
            train_ft_cat_ser.adamw_spec(c.FT_LR), 1, False, torch.tensor(
                c.FT_WEIGHTS, dtype=torch.float32, device=device),
            graphs=False)
        run(state, {k: v.to(device) for k, v in data.items()},
            TrainRNG(c.SEED, 0))
        return state.grads.double().cpu(), acts, grads

    def plain_fwd(keep_f32):
        def fwd(x, kernel, bias, scale, ln_bias, eps, save):
            w = kernel.to(x.dtype).float().permute(2, 1, 0)
            z = F.conv1d(x.float().transpose(1, 2), w, stride=2)
            z = z.transpose(1, 2) + bias.float()
            mean = z.mean(-1, keepdim=True)
            var = torch.clamp((z * z).mean(-1, keepdim=True) - mean * mean,
                              min=0.0)
            rstd = torch.rsqrt(var + eps)
            xh = (z - mean) * rstd
            out = F.gelu(xh * scale.float() + ln_bias.float())
            return out.to(x.dtype), xh if keep_f32 else xh.to(x.dtype), rstd
        return fwd

    def plain_bwd(round_dz):
        def bwd(dout, x, xhat, rstd, kernel, scale, ln_bias):
            dx, *rest = FF.conv_ln_gelu_plain_bwd(
                dout.to(x.dtype), x if round_dz else x.float(), xhat, rstd,
                kernel, scale, ln_bias)
            return (dx.to(x.dtype), *rest)
        return bwd

    kernels = FF._kernel_fwd, FF._kernel_bwd
    cfg = WavLMConfig.large(num_hidden_layers=4, **quiet)
    for seed in seeds:
        data = c._ft_batches(1, 2, c.FT_CLIP_SECONDS, cpu, c.SEED + seed)[0]
        ref = step(cfg, data, cpu, seed)[0]
        line = []
        for name, fwd, bwd in (
                ("K6", *kernels),
                ("plain, x^ and dz bf16", plain_fwd(False), plain_bwd(True)),
                ("plain, x^ float32", plain_fwd(True), plain_bwd(True)),
                ("plain, x^ and dz float32", plain_fwd(True),
                 plain_bwd(False))):
            FF._kernel_fwd, FF._kernel_bwd = fwd, bwd
            try:
                g = step(cfg, data, cuda, seed)[0]
            finally:
                FF._kernel_fwd, FF._kernel_bwd = kernels
            line.append(f"{name} {float(F.cosine_similarity(g, ref, dim=0)):.6f}")
        print(f"[probe] 4 layers, seed {seed}: the step's gradient cosine "
              f"against float32: " + ", ".join(line), flush=True)

    watch = ["ssl.feature_extractor", "ssl.encoder.layer_norm", "pool",
             "ser.norm_0", "ser"]
    for layers, seed in ((4, 13), (1, 25)):
        cfg = WavLMConfig.large(num_hidden_layers=layers, **quiet)
        data = c._ft_batches(1, 2, c.FT_CLIP_SECONDS, cpu, c.SEED + seed)[0]
        noisy = dict(data)
        noisy["input_values"] = data["input_values"] * (
            1 + 2.0 ** -16 * torch.randn(data["input_values"].shape,
                                         generator=torch.Generator()
                                         .manual_seed(7)))
        g0, a0, d0 = step(cfg, data, cpu, seed, watch)
        for what, (g, a, d) in (
                ("float32, input x (1 + 2^-16 noise)",
                 step(cfg, noisy, cpu, seed, watch)),
                ("bf16 on the card", step(cfg, data, cuda, seed, watch))):
            rel = {n: (float((a[n] - a0[n]).norm() / a0[n].norm()),
                       float((d[n] - d0[n]).norm() / d0[n].norm()))
                   for n in watch}
            print(f"[probe] {layers} layers, seed {seed}, {what}: gradient "
                  f"cosine {float(F.cosine_similarity(g, g0, dim=0)):.6f}; "
                  f"relative change of each output / of the gradient "
                  f"arriving there: " + ", ".join(
                      f"{n} {o:.2e} / {q:.2e}" for n, (o, q) in rel.items()),
                  flush=True)


if __name__ == "__main__":
    {"variance": variance, "gradients": gradients}[sys.argv[1]]()
