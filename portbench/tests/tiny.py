"""Tiny sizes at which the CPU tests drive whole runs of each cell (the
port's plain paths, float32): WavLM-large's conv stack at narrow widths
and two layers."""

TINY_ENCODER = {"hidden_size": 64, "num_hidden_layers": 2,
                "num_attention_heads": 4, "intermediate_size": 128,
                "conv_dim": [16] * 7, "num_conv_pos_embeddings": 16,
                "num_conv_pos_embedding_groups": 4, "num_buckets": 40,
                "max_bucket_distance": 100, "layerdrop": 0.3}

OVERRIDES = {
    "byol-train-5s": {
        "config": {"encoder": TINY_ENCODER,
                   "model": {"projection_dim": 16, "prediction_dim": 32},
                   "data": {"batch_size": 4, "max_audio_length": 0.5}},
        "traffic": {"groups": [
            {"name": "clean", "kind": "speech", "count": 16,
             "seconds": [0.5, 1.5]},
            {"name": "noise", "kind": "noise", "count": 4,
             "seconds": [1.0, 1.0]}]},
        # three followed steps: over the card's eight, float32 round-off
        # in the target's EMA of leaves near 1 grows past the schema
        # test's margin (1% of the card's limit) at this size
        "workload": {"check_steps": 3, "trace_warm": 1, "trace_steps": 2}},
    "ser-finetune-10s": {
        "config": {"encoder": TINY_ENCODER,
                   "head": {"head_dim": 32},
                   "data": {"batch_size": 4, "max_seconds": 8.0}},
        "traffic": {"groups": [
            {"name": "clips", "kind": "speech", "count": 16,
             "seconds": [2.0, 9.0]}]},
        "workload": {"trace_warm": 1, "trace_steps": 2}},
    "ser-eval-ragged": {
        "config": {"encoder": TINY_ENCODER, "head": {"head_dim": 32},
                   "data": {"batch_size": 4}},
        "traffic": {"groups": [
            {"name": "short", "kind": "speech", "count": 6,
             "seconds": [1.0, 4.0]},
            {"name": "long", "kind": "speech", "count": 2,
             "seconds": [6.0, 9.0]}]},
        "workload": {"reference_rows": 4}},
}
