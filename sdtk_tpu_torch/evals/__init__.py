"""Held-out evaluation and calibration of a checkpoint on the GPU.

``python -m sdtk_tpu_torch.evals.eer`` (verification EER on the held-out
voice family), ``.calibrate`` (fits a checkpoint's ``.calib.json`` and
``.cohort.npy`` sidecars) and ``.der`` (DER on synthetic meetings or a
WAV + RTTM corpus): the counterparts of ``evals/benchmark_eer.py``,
``evals/calibrate_threshold.py`` and ``evals/benchmark_der.py``, with the
same flags plus ``--device`` and the same JSON line.
"""
