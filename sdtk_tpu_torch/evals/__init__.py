"""Held-out evaluation, calibration and the other eval scripts on the GPU.

``python -m sdtk_tpu_torch.evals.eer`` (verification EER on the held-out
voice family), ``.calibrate`` (fits a checkpoint's ``.calib.json`` and
``.cohort.npy`` sidecars), ``.der`` (DER on synthetic meetings or a
WAV + RTTM corpus), ``.identify`` (identification pass rate),
``.streaming`` (the online diarizer's latency and real-time factor, or
its DER), ``.mapper`` (the name mapper's accuracy) and ``.warmup``
(deploy-time warm-up of the serving shapes): the counterparts of
``evals/benchmark_eer.py``, ``calibrate_threshold.py``,
``benchmark_der.py``, ``benchmark_identify.py``,
``benchmark_streaming.py``, ``benchmark_mapper.py`` and ``warmup.py``,
with the same flags plus ``--device`` and the same JSON line.  The speed
harnesses ``.benchmark_scaling`` (the serving embed over 1..N cards, one
rank a card), ``.benchmark_topk`` (the fused identify top-k against the
library at catalog scale), ``.benchmark_frontend`` (the plain log-mel
against both log-mel kernels), ``.benchmark_decode`` (the host's WAV
decode) and ``run_matrix.sh`` (the DER matrix) follow the JAX scripts of
those names the same way; ``.mfu_probe`` is the probe's.
"""
