"""sdtk_tpu_torch — the PyTorch/CUDA port of ``sdtk_tpu``.

Offline diarization of one recording, end to end, on an NVIDIA GPU:
``pipeline.diarize.Diarizer(device="cuda").diarize_waveform(wav)``.  The
waveform→log-mel frontend is a hand-written CUDA kernel
(``csrc/log_mel_wave.cu``, built with ``nvcc`` on first use into
``_build/``); the ECAPA-TDNN tower runs in PyTorch.  Host stages (VAD,
denoise, turn clustering, resegmentation, boundaries, DER) are NumPy
copies of the JAX package's.  Beside it: enroll / identify / verify
(``pipeline.identify``), streaming (``pipeline.streaming``), speaker
assignment from STT transcripts (``pipeline.assign``) and the batch
queue (``pipeline.process``).  The package imports neither JAX nor
anything of ``sdtk_tpu``.
"""

__version__ = "0.1.0"
