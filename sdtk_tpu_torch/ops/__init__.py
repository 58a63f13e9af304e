"""The port's hand-written kernels and their wrappers."""


def kernel_wrappers() -> dict:
    """Every kernel wrapper, by kernel name (each counts its launches in
    ``.launches``, through ``utils/profiling.py:launched``)."""
    from . import cosine, fbank_frames, fbank_wave, topk_fused, tower_epilogue

    return {"log_mel_wave": fbank_wave.log_mel_wave, "cosine": cosine.cosine,
            "identify_topk": topk_fused.identify_topk_fused,
            "fbank_frames": fbank_frames.fbank_frames,
            "tower_epilogue": tower_epilogue.tower_epilogue}
