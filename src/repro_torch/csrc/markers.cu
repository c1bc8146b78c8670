// Timing events for the stream's device markers (engine/spans.py): made
// on a device, recorded on a stream, one batch's three markers read
// against the batch before once they ran, freed.  Plain runtime calls
// behind one C call each, so that a batch's markers cost the host a few
// microseconds.  Each returns a cudaError_t (0: success).
#include <cuda_runtime.h>

extern "C" int repro_event_create(int device, void** out) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  cudaEvent_t ev = nullptr;
  if (err == cudaSuccess) err = cudaEventCreate(&ev);
  if (prev != device) {
    cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  *out = ev;
  return static_cast<int>(err);
}

extern "C" int repro_event_destroy(void* ev) {
  return static_cast<int>(cudaEventDestroy(static_cast<cudaEvent_t>(ev)));
}

extern "C" int repro_event_record(void* ev, void* stream) {
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(ev),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int repro_event_synchronize(void* ev) {
  return static_cast<int>(
      cudaEventSynchronize(static_cast<cudaEvent_t>(ev)));
}

// ms from `prev` to `m0`, from `m0` to `m1` and from `m1` to `m2` into
// out[0..2] once `m2` ran (all four on one stream, in that order);
// cudaErrorNotReady while it has not.
extern "C" int repro_marker_times(void* prev, void* m0, void* m1, void* m2,
                                  float* out) {
  cudaError_t err = cudaEventQuery(static_cast<cudaEvent_t>(m2));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* ev[4] = {prev, m0, m1, m2};
  for (int i = 0; i < 3; ++i) {
    err = cudaEventElapsedTime(&out[i], static_cast<cudaEvent_t>(ev[i]),
                               static_cast<cudaEvent_t>(ev[i + 1]));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// ms from `a` to `b`, both of which ran.
extern "C" int repro_event_elapsed(void* a, void* b, float* out) {
  return static_cast<int>(cudaEventElapsedTime(
      out, static_cast<cudaEvent_t>(a), static_cast<cudaEvent_t>(b)));
}
