"""The train steps captured under an NCCL mesh, on four cards.

    python3 tools/mesh_step_graphs.py [--cases a,b] [--log PATH]

(from the root of a checkout, on one host with four cards.)

One rank a card over NCCL (``parallel.launch.run_ranks(...,
backend="nccl")``, a fresh group a case), WavLM-large at full width and
depth, seeded weights, every random feature on (the JAX preset's dropout,
LayerDrop and SpecAugment).  In each case the captured step (``train.
step_graphs``, the mesh's collectives inside its parts) and an eager twin
from the same weights take 7 steps in lockstep, and every rank checks
after each step: the metrics and every tensor the step changes bit for
bit (BYOL: loss, grad_norm, valid_fraction, finite, the gradients,
params, mu, nu, the target and both towers' BatchNorm statistics; SER:
loss, grad_norm, the gradients, params, mu, nu), the replicas agreeing
(``replicas_agree``), no kernel wrapper launched in a replay.  Each case
also times both forms in turns (captured, eager, eager, captured; host
clock and CUDA events) and records the capture's seconds and the memory it
reserved, per rank.  The cases:

  * ``byol_data4``: BYOL at ``{data: 4}``, 36 × 5 s a rank (global batch
    144); then the eval and embed steps from their programs against their
    eager forms, bit for bit;
  * ``byol_tp``: BYOL at ``{data: 2, model: 2}``, 36 × 5 s a data rank;
    then, for the record, phase 20(a)'s agreement with one rank: random
    features off, 4 steps of the sharded step against one rank at
    ``model: 1`` on the global batch (``chip_smoke._drift``);
  * ``ser_data4``: the SER trainers' step (``--task both``, 36 × 5 s a
    rank) at ``{data: 4}``, frozen and whole encoder;
  * ``ser_tp``: the same at ``{data: 2, model: 2}``, the whole encoder,
    replicated over each model group (the step's ``check_replicas``);
  * ``entry_tp``: ``train_byol.main`` at ``{data: 2, model: 2}``, 2 layers
    deep, 2 epochs, captured and with ``training.cuda_graphs: false``:
    both runs reach the same state bits on every rank;
  * ``ser_entry``: ``train_categorical_emotions`` called alone in four
    processes started as torchrun starts them (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), at ``{data: 2,
    model: 2}``, 2 layers deep, one epoch a phase: it joins the group,
    trains captured and leaves the group with its state's graphs alive,
    and every process exits 0;
  * ``capture_fails``: ``train_byol.main`` likewise, its head's capture
    made to fail (a synchronize while capturing, after the layers'
    collectives were captured): every process raises the capture's
    error, naming the part, leaves the group and exits.

Writes every rank's lines to ``--log`` (``build/mesh_step_graphs.log`` by
default) and prints the card, each rank's lines as they come and a
summary line a case; exits 1 if a case failed.
``--cases a,b`` runs some of them; ``--threads N`` sets each rank's torch
CPU threads (default 1; ``OMP_NUM_THREADS`` in the started processes).  ``--cpu`` rehearses the cases over
gloo on the CPU at the tiny configuration (4 layers), where nothing is
captured and both forms run eagerly.
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from nrse_tpu_torch import train_byol  # noqa: E402
from nrse_tpu_torch.models.wavlm import WavLMConfig  # noqa: E402
from nrse_tpu_torch.parallel.distributed import barrier  # noqa: E402
from nrse_tpu_torch.parallel.launch import free_port, run_ranks  # noqa: E402
from nrse_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh,
    replicas_agree,
    shard_batch,
)
from nrse_tpu_torch.runtime import cuda_build  # noqa: E402
from nrse_tpu_torch.train import byol_trainer, emotion_trainer  # noqa: E402

STEPS = 7        # in lockstep
TIMED = 5        # steps a turn
CLIPS = 36       # a data rank's clips
LOG = os.path.join("build", "mesh_step_graphs.log")


def _config(cpu: bool) -> WavLMConfig:
    if cpu:
        return dataclasses.replace(WavLMConfig.tiny(), num_hidden_layers=4,
                                   layerdrop=0.3)
    return WavLMConfig.large()


def _sizes(cpu: bool) -> dict:
    """The widths and batch of a run: full on the card, tiny on the CPU."""
    if cpu:
        return {"proj": 32, "pred": 64, "hidden": 32, "clips": 2,
                "seconds": 0.2, "timed": 2}
    return {"proj": 1024, "pred": 2048, "hidden": cs.EMO_HIDDEN,
            "clips": CLIPS, "seconds": cs.CLIP_SECONDS, "timed": TIMED}


class _Rank:
    """A rank's log lines and its failures."""

    def __init__(self, rank: int):
        self.rank, self.lines, self.bad = rank, [], []

    def log(self, msg: str) -> None:
        line = f"[rank {self.rank}] {msg}"
        self.lines.append(line)
        print(line, flush=True)  # the progress of a rank that hangs

    def out(self, **kw) -> dict:
        """What the rank returns."""
        return {"rank": self.rank, "lines": self.lines, "bad": self.bad,
                **kw}

    def fail(self, msg: str) -> None:
        self.bad.append(msg)
        self.log(f"FAILED: {msg}")



def _rank_device(rank: int, device: str) -> torch.device:
    """The rank's card (``cuda:rank``, one rank a card) made current, TF32
    off; or the CPU."""
    return cs._rank_device(f"cuda:{rank}" if device == "cuda" else device)


def _reserved(device) -> float:
    if device.type != "cuda":
        return float("nan")
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device) / 2**30


def _lockstep(r: _Rank, what: str, step_c, step_e, state_c, state_e, keys,
              tensors, keep_of, agree, device) -> dict:
    """``STEPS`` steps of both forms in lockstep, checked after each;
    returns the capture's seconds and reserved memory and the layers
    dropped by tower."""
    captures = device.type == "cuda"
    before = _reserved(device)
    replay_launches, dropped, capture_s, pool = 0, None, float("nan"), None
    for i in range(STEPS):
        keep = keep_of(state_c)
        counts = [len(k) - sum(k) for k in keep]
        dropped = counts if dropped is None else [
            a + b for a, b in zip(dropped, counts)]
        cs._reset_counts()
        mc = step_c(state_c)
        if i:
            replay_launches += sum(cs._train_counts().values())
        elif captures:
            capture_s = state_c.graphs.capture_s
            pool = _reserved(device) - before
        me = step_e(state_e)
        differ = cs._differ(mc, me, tensors(state_c), tensors(state_e), keys)
        agrees = agree(state_c) and agree(state_e)
        r.log(f"{what} step {i}: captured = eager {not differ} (loss "
              f"{float(mc['loss']):.6f}, grad_norm "
              f"{float(mc['grad_norm']):.4f}); replicas agree {agrees}; "
              f"layers dropped {counts}")
        if differ or not agrees:
            r.fail(f"{what} step {i}: differ in {differ}, replicas agree "
                   f"{agrees}")
    if not all(dropped):
        r.fail(f"{what}: a tower dropped no layer in {STEPS} steps: "
               f"{dropped}")
    if captures and replay_launches:
        r.fail(f"{what}: wrappers launched {replay_launches} times in "
               f"replays")
    r.log(f"{what}: {STEPS} steps in lockstep; dropped {dropped}; wrapper "
          f"launches in {STEPS - 1} replays {replay_launches}; captured in "
          f"{capture_s:.2f} s, "
          f"{len(state_c.graphs.graphs) if captures else 0} graphs, "
          f"{pool if pool is not None else float('nan'):.2f} GiB reserved")
    return {"capture_s": capture_s, "reserved_gib": pool,
            "dropped": dropped, "replay_launches": replay_launches}


def _timed(r: _Rank, what: str, step_c, step_e, state_c, state_e, steps,
           device) -> dict:
    barrier()
    times = cs._in_turns({"captured": lambda: step_c(state_c),
                          "eager": lambda: step_e(state_e)}, steps, device)
    r.log(f"{what}: s/step in turns, host clock (CUDA events) "
          f"{cs._turns_line(times)}")
    return times


def _byol_keys():
    return ("loss", "grad_norm", "valid_fraction", "finite", "layers_online",
            "layers_target")


def _byol_tensors(st) -> dict:
    return {**st.tensors(), "grads": st.grads}


def byol_case(rank: int, world: int, device: str, cpu: bool,
              model: int) -> dict:
    """BYOL at ``{data: world / model, model: model}``: the lockstep and
    the timing; at ``model: 1`` the eval and embed steps from their
    programs; at ``model: 2`` the record of phase 20(a)'s agreement with
    one rank."""
    r = _Rank(rank)
    device = _rank_device(rank, device)
    cfg, z = _config(cpu), _sizes(cpu)
    mesh = make_mesh(model=model, device=device,
                     heads=cfg.num_attention_heads)
    sd = cs.with_random_biases(cs.init_byol_state_dict(
        cfg, z["proj"], z["pred"], torch.Generator().manual_seed(cs.SEED)),
        cs.SEED)
    state_c, state_e = (cs._byol_state(cfg, sd, device, z["proj"],
                                       z["pred"], mesh) for _ in range(2))
    step_c = cs.make_byol_train_step(cs._adamw_spec())
    step_e = cs.make_byol_train_step(cs._adamw_spec(), graphs=False)
    local = shard_batch(mesh, cs._train_batch(z["clips"] * mesh.data,
                                              z["seconds"], device))
    what = (f"BYOL at {{data: {mesh.data}, model: {mesh.model}}}, "
            f"{z['clips']} x {z['seconds']:g} s a data rank")
    out = _lockstep(r, what, lambda st: step_c(st, local),
                    lambda st: step_e(st, local), state_c, state_e,
                    _byol_keys(), _byol_tensors,
                    lambda st: cs._byol_keeps(st, 1)[0],
                    byol_trainer.replicas_agree, device)
    out["times"] = _timed(r, what, lambda st: step_c(st, local),
                          lambda st: step_e(st, local), state_c, state_e,
                          z["timed"], device)
    if model == 1:
        out["eval"] = _eval_steps(r, state_c, local)
    del state_c, state_e
    if model > 1:
        out["one_rank"] = _one_rank_record(r, cfg, mesh, z, device)
    cs.sync(device)
    return r.out(**out)


def _eval_steps(r: _Rank, state, local) -> dict:
    """The eval and embed steps from their programs (captured at the
    first call of each, replayed at the second) against their eager
    forms, bit for bit."""
    out = {}
    for embeddings in (False, True):
        programs = byol_trainer.make_byol_eval_step(embeddings)
        eager = byol_trainer.make_byol_eval_step(embeddings, graphs=False)
        programs(state, local)
        cs._reset_counts()
        got = programs(state, local)
        launches = sum(cs._train_counts().values())
        want = eager(state, local)
        same = len(got) == len(want) and all(
            torch.equal(g, w) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        cache = state.programs.get((embeddings, True))
        captured = cache.captured if cache else 0
        name = "embed" if embeddings else "eval"
        r.log(f"BYOL {name} step from its program ({captured} captured): "
              f"= eager bit for bit {same}, finite {finite}, wrapper "
              f"launches in the replay {launches}")
        if not same or not finite or (
                state.params.device.type == "cuda"
                and (launches or not captured)):
            r.fail(f"BYOL {name} step from its program: equal {same}, "
                   f"finite {finite}, launches {launches}")
        out[name] = same
    return out


def _one_rank_record(r: _Rank, cfg, mesh, z, device) -> dict:
    """Phase 20(a)'s agreement with one rank, for the record: random
    features off, ``cs.DP_STEPS + 1`` steps of the sharded eager step
    against rank 0 alone at ``model: 1`` on the global batch, from the
    same weights: the first step's and the largest relative differences
    of loss and grad_norm, the parameter deltas' cosine and distance."""
    quiet = cs._quiet(cfg)
    sd = cs.with_random_biases(cs.init_byol_state_dict(
        quiet, z["proj"], z["pred"], torch.Generator().manual_seed(cs.SEED)),
        cs.SEED)
    steps = cs.DP_STEPS + 1
    step = cs.make_byol_train_step(cs._adamw_spec(), graphs=False)
    batch = cs._train_batch(z["clips"] * mesh.data, z["seconds"], device)
    ref = None
    if r.rank == 0:
        st = cs._byol_state(quiet, sd, device, z["proj"], z["pred"])
        start = st.params.clone()
        ms = [step(st, batch) for _ in range(steps)]
        ref = {k: [float(m[k]) for m in ms] for k in ("loss", "grad_norm")}
        ref["delta"] = st.params - start
        del st, start, ms
        cs.sync(device)
    barrier()
    st = cs._byol_state(quiet, sd, device, z["proj"], z["pred"], mesh)
    start = st.checkpoint_tensors()["params"].clone()
    ms = [step(st, shard_batch(mesh, batch)) for _ in range(steps)]
    got = {k: [float(m[k]) for m in ms] for k in ("loss", "grad_norm")}
    delta = st.checkpoint_tensors()["params"] - start
    out = None
    if r.rank == 0:
        out = cs._drift(got, delta, ref)
        r.log(f"for the record, phase 20(a)'s agreement with one rank "
              f"(features off, {steps} steps, {{data: {mesh.data}, model: "
              f"{mesh.model}}} against one rank on the global batch): "
              f"{json.dumps(out)}")
    return out


def _ser_state(cfg, device, hidden: int, mesh, batch: int):
    st = emotion_trainer.create_emotion_state(
        cs._emotion_model(cfg, device, hidden, cs.EMO_DROPOUT), cs.SEED)
    return emotion_trainer.make_batch_placer(mesh, batch)[1](st)


def ser_case(rank: int, world: int, device: str, cpu: bool, model: int,
             runs) -> dict:
    """The SER step at ``{data: world / model, model: model}``, each of
    ``runs`` (``frozen``, ``whole``): the lockstep and the timing."""
    r = _Rank(rank)
    device = _rank_device(rank, device)
    cfg, z = _config(cpu), _sizes(cpu)
    n = cfg.num_hidden_layers
    mesh = make_mesh(model=model, device=device,
                     heads=cfg.num_attention_heads)
    rows = z["clips"] * mesh.data
    place_batch, _ = emotion_trainer.make_batch_placer(mesh, rows)
    local = place_batch(cs._emotion_batch(rows, z["seconds"] * 2.4 if cpu
                                          else z["seconds"], device,
                                          cs.SEED + 15))
    weights = torch.tensor(cs.FT_WEIGHTS, dtype=torch.float32,
                           device=device)
    step_c = emotion_trainer.make_emotion_train_step("both", cs.EMO_WD)
    step_e = emotion_trainer.make_emotion_train_step("both", cs.EMO_WD,
                                                     graphs=False)
    keys = {"frozen": ([], 0.0, cs.EMO_LR),
            "whole": (list(range(n)), 1.0, cs.EMO_FT_LR)}
    out = {}
    for name in runs:
        layers, rest, lr = keys[name]
        state_c = _ser_state(cfg, device, z["hidden"], mesh, rows)
        state_e = _ser_state(cfg, device, z["hidden"], mesh, rows)

        def step(fn):
            return lambda st: fn(st, local, weights, layers, lr, rest)

        what = (f"SER step, {name}, at {{data: {mesh.data}, model: "
                f"{mesh.model}}}, {z['clips']} clips a data rank")
        res = _lockstep(
            r, what, step(step_c), step(step_e), state_c, state_e,
            ("loss", "grad_norm", "layers_run"),
            lambda st: {**st.tensors(), "grads": st.grads},
            lambda st: (st.model.encoder.encoder.layer_keep(
                cs.TrainRNG(st.seed, st.step, 0, mesh.data_index,
                            mesh.data)),),
            lambda st: replicas_agree(mesh, st.tensors().values()), device)
        res["times"] = _timed(r, what, step(step_c), step(step_e), state_c,
                              state_e, z["timed"], device)
        out[name] = res
        del state_c, state_e
        cs.sync(device)
    return r.out(**out)


def entry_case(rank: int, world: int, device: str, cpu: bool,
               config: dict) -> dict:
    """``train_byol.main`` at the config's mesh, captured and eager, from
    one seed: the same state bits on this rank."""
    r = _Rank(rank)
    dev = _rank_device(rank, device)
    cfg = dataclasses.replace(_config(cpu), num_hidden_layers=2)
    runs = {}
    for graphs in (True, False):
        c = json.loads(json.dumps(config))
        c["training"]["cuda_graphs"] = graphs
        c["training"]["checkpoint_dir"] += f"_{int(graphs)}"
        cs._reset_counts()
        res = train_byol.main(c, cfg)
        cs.sync(dev)
        st = res["state"]
        runs[graphs] = {"tensors": {k: t.clone() for k, t in
                                    st.tensors().items()},
                        "captured": st.graphs is not None,
                        "epochs": [(e["train_loss"], e["val_loss"],
                                    e["s_per_step"]) for e in res["epochs"]],
                        "counts": cs._train_counts()}
        del res, st
    a, b = runs[True], runs[False]
    differ = [k for k in a["tensors"]
              if not torch.equal(a["tensors"][k], b["tensors"][k])]
    r.log(f"train_byol.main at {config['tpu']['mesh']}, 2 layers, 2 epochs: "
          f"the captured run (captured {a['captured']}) and the eager run "
          f"(captured {b['captured']}) reach the same state bits "
          f"{not differ}; epochs (train loss, val loss, s/step) captured "
          f"{a['epochs']}, eager {b['epochs']}; launches of the eager run "
          f"{b['counts']}")
    on_card = dev.type == "cuda"
    if differ or a["captured"] != on_card or b["captured"]:
        r.fail(f"train_byol.main: differ in {differ}, captured "
               f"{a['captured']} / {b['captured']}")
    return r.out(epochs={"captured": a["epochs"], "eager": b["epochs"]})


def _entry_config(root: str, cpu: bool) -> dict:
    seconds = 0.3 if cpu else cs.CLIP_SECONDS
    clean, noise = cs._write_corpus(os.path.join(root, "byol"), 24, 4,
                                    seconds)
    z = _sizes(cpu)
    return {
        "model": {"name": "wavlm-tiny" if cpu else "microsoft/wavlm-large",
                  "projection_dim": z["proj"], "prediction_dim": z["pred"],
                  "ema_decay": 0.997},
        "training": {"batch_size": 8, "num_workers": 4, "num_epochs": 2,
                     "learning_rate": 1e-5, "weight_decay": 1e-5,
                     "seed": cs.SEED, "save_checkpoints": False,
                     "checkpoint_dir": os.path.join(root, "ckpt"),
                     "log_dir": os.path.join(root, "logs")},
        "data": {"clean_data_path": clean, "noise_data_path": noise,
                 "sample_rate": cs.SAMPLE_RATE, "max_audio_length": seconds,
                 "snr_range": [0, 5, 10, 15, 20], "validation_ratio": 0.25},
        "tpu": {"mesh": {"data": 2, "model": 2}},
        "device": "cpu" if cpu else "cuda"}


def _ser_entry_config(root: str) -> dict:
    """The SER entry's config: ``chip_smoke``'s, WavLM-large cut to 2
    layers, global batch 8 at ``{data: 2, model: 2}``, one epoch a
    phase."""
    return cs._emotion_entry_config(
        root, "microsoft/wavlm-large", 2, 8, cs.CLIP_SECONDS, (16, 8), 2.0,
        8.0, cs.EMO_HIDDEN, "cuda", mesh={"data": 2, "model": 2})


def rank_entry(which: str, config_path: str) -> int:
    """One process of ``ser_entry`` or ``capture_fails``, in the group
    torchrun's variables describe: 0 where it ran as the case wants and
    left the group."""
    import torch.distributed as dist

    from nrse_tpu_torch.train import categorical_emotions

    with open(config_path) as f:
        config = json.load(f)
    rank = os.environ["RANK"]
    if which == "ser_entry":
        res = categorical_emotions.train_categorical_emotions(config)
        graphs = res["state"].graphs
        ok = graphs is not None and not dist.is_initialized()
        print(f"[rank {rank}] train_categorical_emotions: best f1 "
              f"{res['best_f1']:.4f}, captured {graphs is not None}, the "
              f"group left {not dist.is_initialized()}", flush=True)
        return 0 if ok else 1
    real = byol_trainer.byol_loss

    def byol_loss(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()  # refused while capturing
        return real(*args, **kwargs)

    byol_trainer.byol_loss = byol_loss
    encoder = dataclasses.replace(WavLMConfig.large(), num_hidden_layers=2)
    try:
        train_byol.main(config, encoder)
    except RuntimeError as e:
        said = str(e).splitlines()[0]
        print(f"[rank {rank}] train_byol.main raised: {said}; the group "
              f"left {not dist.is_initialized()}", flush=True)
        return 0 if "in part 'head'" in said and not dist.is_initialized() \
            else 1
    print(f"[rank {rank}] train_byol.main did not raise", flush=True)
    return 1


def torchrun_case(name: str, config: dict, root: str, threads: int,
                  limit: float, say) -> bool:
    """Four processes of :func:`rank_entry` ``name``, one a card, started
    as torchrun starts them; each one's output logged.  True where every
    one exited 0 within ``limit`` seconds; the rest are killed."""
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(config, f)
    port = free_port()
    procs = []
    for rank in range(4):
        env = dict(os.environ, WORLD_SIZE="4", RANK=str(rank),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="4",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS=str(threads or os.cpu_count()))
        out = open(os.path.join(root, f"{name}_{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-entry", name,
             path], env=env, stdout=out, stderr=subprocess.STDOUT), out))
    deadline = time.monotonic() + limit
    codes = []
    for p, out in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    for p, out in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        out.close()
    for rank in range(4):
        with open(os.path.join(root, f"{name}_{rank}.log")) as f:
            for line in f.read().splitlines():
                say(f"[{name}] [process {rank}] {line}", echo=False)
    say(f"[mesh] {name}: exit codes {codes} (None: still running after "
        f"{limit:.0f} s, killed)")
    return all(c == 0 for c in codes)


CASES = ("byol_data4", "byol_tp", "ser_data4", "ser_tp", "entry_tp",
         "ser_entry", "capture_fails")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cases", default=",".join(CASES))
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--log", default=LOG)
    # torch's CPU threads a rank: 1, as torchrun sets OMP_NUM_THREADS for
    # several ranks a host (0: torch's default, every core in every rank,
    # whose host draws then contend: PERF.md)
    parser.add_argument("--threads", type=int, default=1)
    # one process of a torchrun case: its name and its config's path
    parser.add_argument("--rank-entry", nargs=2, metavar=("CASE", "CONFIG"))
    args = parser.parse_args(argv)
    if args.rank_entry:
        return rank_entry(*args.rank_entry)
    cpu = args.cpu
    if not cpu and torch.cuda.device_count() < 4:
        print("needs four cards on this host", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(args.log) or ".", exist_ok=True)
    log = open(args.log, "w")

    def say(msg: str, echo: bool = True) -> None:
        log.write(msg + "\n")
        log.flush()
        if echo:
            print(msg, flush=True)

    if not cpu:
        say(f"[mesh] card: {cs.card()}")
        say(f"[mesh] torch {torch.__version__} cuda {torch.version.cuda} "
            f"nccl {'.'.join(map(str, torch.cuda.nccl.version()))}, "
            f"{torch.cuda.device_count()} cards")
        t0 = time.perf_counter()
        cuda_build.build()
        say(f"[mesh] kernels built in {time.perf_counter() - t0:.1f} s")
    backend, device = ("gloo", "cpu") if cpu else ("nccl", "cuda")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="mesh_", dir=cuda_build.BUILD_DIR)
    # each case's function, arguments and time limit (s): about twice
    # what a run takes on the card
    calls = {"byol_data4": (byol_case, (device, cpu, 1), 100),
             "byol_tp": (byol_case, (device, cpu, 2), 130),
             "ser_data4": (ser_case, (device, cpu, 1, ("frozen", "whole")),
                           150),
             "ser_tp": (ser_case, (device, cpu, 2, ("whole",)), 100),
             "entry_tp": (entry_case, (device, cpu,
                                       _entry_config(root, cpu)), 120)}
    entries = {"ser_entry": (_ser_entry_config, 150),
               "capture_fails": (lambda r: _entry_config(r, False), 100)}
    failed = []
    try:
        for name in args.cases.split(","):
            if name in entries:
                if cpu:
                    say(f"[mesh] {name}: runs on four cards only")
                    continue
                make, limit = entries[name]
                t0 = time.perf_counter()
                ok = torchrun_case(name, make(os.path.join(root, name)),
                                   root, args.threads, limit, say)
                if not ok:
                    failed.append(name)
                say(f"[mesh] {name}: {'ok' if ok else 'FAILED'} in "
                    f"{time.perf_counter() - t0:.1f} s")
                continue
            fn, fn_args, limit = calls[name]
            t0 = time.perf_counter()
            try:
                ranks = run_ranks(fn, 4, fn_args, backend=backend,
                                  threads=args.threads,
                                  timeout=limit * (3 if cpu else 1))
            except RuntimeError as e:
                failed.append(name)
                say(f"[mesh] {name}: FAILED after "
                    f"{time.perf_counter() - t0:.1f} s: {e}")
                continue
            for rk in ranks:
                for line in rk["lines"]:
                    say(f"[{name}] {line}", echo=False)
            bad = [b for rk in ranks for b in rk["bad"]]
            if bad:
                failed.append(name)
            summary = {k: v for k, v in ranks[0].items()
                       if k not in ("lines", "bad", "rank")}
            say(f"[mesh] {name}: {'FAILED ' + str(bad) if bad else 'ok'} in "
                f"{time.perf_counter() - t0:.1f} s; rank 0: "
                f"{json.dumps(summary, default=str)}")
            for rk in ranks[1:]:
                caps = {k: (v.get("capture_s"), v.get("reserved_gib"))
                        for k, v in rk.items() if isinstance(v, dict)
                        and "capture_s" in v}
                if "capture_s" in rk:  # a case of one run
                    caps["step"] = (rk["capture_s"], rk["reserved_gib"])
                if caps:
                    say(f"[mesh] {name}: rank {rk['rank']} capture s and "
                        f"reserved GiB {caps}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        log.close()
    print(f"[mesh] failed: {failed}" if failed else "[mesh] every case ok",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
