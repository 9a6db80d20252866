// Batched JPEG decode and single-image encode on the card through nvJPEG,
// the toolkit's JPEG library: the role OpenCV's libjpeg plays for the JAX
// package's camera loader (cv2.imread) and synthetic generator
// (cv2.imwrite).  A library call, not a port of a TPU kernel: the JAX
// package decodes on the host.  data/jpeg.py wraps it; kernels/_build.py
// compiles it with nvcc and links libnvjpeg from the toolkit.
//
// One context per process and device (data/jpeg.py caches it): the
// library handle, one batched-decode state (re-initialised only when the
// batch size changes) and, made at first use, one encoder state with its
// parameters.  The decode writes each image's
// planes (NVJPEG_OUTPUT_YUV: Y, Cb, Cr at the stream's own chroma
// sampling) into buffers the caller (PyTorch) allocated, on the caller's
// stream; libjpeg's chroma upsampling and YCbCr -> BGR conversion, which
// nvJPEG's interleaved outputs do not reproduce, follow in the rectify
// kernel (kernels/rectify.py:ycbcr_to_bgr).  Errors come back as codes:
// kNvjpegBase + nvjpegStatus_t, or a cudaError_t below 1000.

#include <cstddef>
#include <cstring>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

constexpr int kNvjpegBase = 1000000;
constexpr int kBufferTooSmall = 2000000;

struct Context {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  int batch = 0;
};

int status_code(nvjpegStatus_t s) {
  return s == NVJPEG_STATUS_SUCCESS ? 0 : kNvjpegBase + static_cast<int>(s);
}

void destroy(Context* c) {
  if (c == nullptr) return;
  if (c->enc_params != nullptr) nvjpegEncoderParamsDestroy(c->enc_params);
  if (c->enc_state != nullptr) nvjpegEncoderStateDestroy(c->enc_state);
  if (c->state != nullptr) nvjpegJpegStateDestroy(c->state);
  if (c->handle != nullptr) nvjpegDestroy(c->handle);
  delete c;
}

}  // namespace

#define NVJ_CHECK(call)                                  \
  do {                                                   \
    const int code_ = status_code(call);                 \
    if (code_ != 0) return code_;                        \
  } while (0)

// A context on the current device with the default backend: on an H100
// the software backends decode alike and about as fast, and the hardware
// decoder refused a handle; *out is null on failure.
extern "C" int nvjpeg_create(void** out) {
  *out = nullptr;
  Context* c = new Context();
  int code = status_code(nvjpegCreateSimple(&c->handle));
  if (code == 0) code = status_code(nvjpegJpegStateCreate(c->handle, &c->state));
  if (code != 0) {
    destroy(c);
    return code;
  }
  *out = c;
  return 0;
}

extern "C" void nvjpeg_destroy(void* ctx) {
  destroy(static_cast<Context*>(ctx));
}

// Decode n baseline JPEGs (host bitstreams data[i] of lengths[i] bytes)
// to planes (NVJPEG_OUTPUT_YUV): image i's Y, Cb, Cr into
// channels[3 * i + k], device buffers of row pitch pitches[3 * i + k]
// bytes, at the stream's own chroma sampling.
extern "C" int nvjpeg_decode(void* ctx, int n,
                             const unsigned char* const* data,
                             const size_t* lengths,
                             unsigned char* const* channels,
                             const int* pitches, void* stream) {
  Context* c = static_cast<Context*>(ctx);
  if (n <= 0) return 0;
  if (c->batch != n) {
    NVJ_CHECK(nvjpegDecodeBatchedInitialize(c->handle, c->state, n, 1,
                                            NVJPEG_OUTPUT_YUV));
    c->batch = n;
  }
  std::vector<nvjpegImage_t> images(static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) {
    std::memset(&images[i], 0, sizeof(nvjpegImage_t));
    for (int k = 0; k < 3; ++k) {
      images[i].channel[k] = channels[3 * i + k];
      images[i].pitch[k] = static_cast<size_t>(pitches[3 * i + k]);
    }
  }
  NVJ_CHECK(nvjpegDecodeBatched(c->handle, c->state, data, lengths,
                                images.data(),
                                static_cast<cudaStream_t>(stream)));
  return 0;
}

// Encode one (height, width, 3) interleaved BGR u8 device image at
// `quality` with 4:2:0 chroma into the host buffer out of *length bytes;
// *length becomes the stream's size.  When the buffer is too small,
// returns kBufferTooSmall with *length the size needed.  Waits for the
// stream: the bitstream is on the host on return.
extern "C" int nvjpeg_encode_bgri(void* ctx, const unsigned char* image,
                                  int width, int height, int quality,
                                  unsigned char* out, size_t* length,
                                  void* stream) {
  Context* c = static_cast<Context*>(ctx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c->enc_state == nullptr) {
    NVJ_CHECK(nvjpegEncoderStateCreate(c->handle, &c->enc_state, s));
    NVJ_CHECK(nvjpegEncoderParamsCreate(c->handle, &c->enc_params, s));
  }
  NVJ_CHECK(nvjpegEncoderParamsSetQuality(c->enc_params, quality, s));
  NVJ_CHECK(nvjpegEncoderParamsSetSamplingFactors(c->enc_params,
                                                  NVJPEG_CSS_420, s));
  nvjpegImage_t source;
  std::memset(&source, 0, sizeof(source));
  source.channel[0] = const_cast<unsigned char*>(image);
  source.pitch[0] = static_cast<size_t>(width) * 3;
  NVJ_CHECK(nvjpegEncodeImage(c->handle, c->enc_state, c->enc_params,
                              &source, NVJPEG_INPUT_BGRI, width, height, s));
  size_t needed = 0;
  NVJ_CHECK(nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state, nullptr,
                                          &needed, s));
  cudaError_t err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (needed > *length) {
    *length = needed;
    return kBufferTooSmall;
  }
  NVJ_CHECK(nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state, out,
                                          &needed, s));
  err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  *length = needed;
  return 0;
}
