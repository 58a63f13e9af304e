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
with the same flags plus ``--device`` and the same JSON line.
"""
