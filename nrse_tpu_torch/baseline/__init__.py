"""The Odyssey-2024 MSP-Podcast baseline pipeline: the composed SER model,
its head, the corpus normalisation and the list-based timed evaluator
(``python -m nrse_tpu_torch.baseline.eval_cat_ser``)."""
