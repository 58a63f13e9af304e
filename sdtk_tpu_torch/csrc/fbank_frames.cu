// Log-mel from materialized frames for Hopper (sm_90a).
//
// Replaces the Pallas kernel sdtk_tpu/ops/research/fbank_frames.py:
// fbank_frames_pallas: (M, win) frames -> windowed DFT (bases with the
// analysis window folded in) -> power -> mel projection -> ln(x + floor),
// giving (M, n_mels) f32.  The spectra and power never leave the block.
//
// Rounding follows the JAX kernel and this package's log_mel_wave.cu: the
// frames are rounded to the compute type, the bases and the mel matrix are
// given in it, products are summed in f32, and the power is rounded to it
// before the mel product.  Like the TPU kernel it always takes the natural
// log; the mel matrix (fmin 20 Hz) is the caller's.
//
// Bound: at the diarizer's frame count (M = 128 x 98 = 12 544, win 400, 257
// bins, 80 mels) the work is ~5.5 GFLOP against ~24 MB of traffic (frames
// in, log-mel out, bases once); on the bf16 tensor cores the card could do
// it in ~7 us (bytes-bound).
//
// Design.  The kernel is dft_mma.cuh's (its header holds the design: tensor
// cores for bf16, CUDA cores for f32) over this file's frame source: frame
// m is row m of the input, read once with coalesced loads (dft::fill_rows).

#include "dft_mma.cuh"

namespace {

struct FrameRows {
  const float* frames;  // (m_frames, win)

  template <int R, typename T>
  __device__ __forceinline__ void fill(T* dst, int stride, int /*rows*/, int m0, int m_frames,
                                       int win, T* /*stage*/, int /*cap*/) const {
    const float* base = frames;
    dft::fill_rows<R>(dst, stride, m0, m_frames, win,
                      [base, win](int m) { return base + (size_t)m * win; });
  }
};

}  // namespace

// frames (m_frames, win) f32; out (m_frames, n_mels) f32.  bf16 compute
// (`bf16` nonzero): `packed` from ops/fbank.py:pack_dft_operands, wr/wi/mel
// unused.  f32 compute: wr, wi (win, n_freqs) and mel (n_freqs, n_mels) f32,
// `packed` unused.  All contiguous on the current device.  Returns a
// cudaError_t.
extern "C" int fbank_frames_launch(const void* frames, const void* wr, const void* wi,
                                   const void* mel, const void* packed, void* out, int m_frames,
                                   int win, int n_freqs, int n_mels, float log_floor, int bf16,
                                   void* stream) {
  if (m_frames <= 0 || win <= 0 || n_freqs <= 0 || n_mels <= 0)
    return (int)cudaErrorInvalidValue;
  const FrameRows src{static_cast<const float*>(frames)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dft::launch_mma(src, packed, out, m_frames, win, n_freqs, n_mels, 0, log_floor, s);
  return dft::launch_fma(src, wr, wi, mel, out, m_frames, win, n_freqs, n_mels, 0, log_floor, s);
}
