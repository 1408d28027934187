// The C entries' hold on the calling thread's current device.
//
// An entry works on the card its tensors live on: it makes that card
// current for the runtime calls it makes, and gives the caller's current
// device back when it returns.  So a launch on card 3 leaves a thread
// whose current card is 0 on card 0, as a torch op on card 3 does, and
// the wrappers in ops/*.py need no device context of their own around a
// launch.
#pragma once
#include <cuda_runtime.h>

struct CurrentDevice {
  int prev = 0;
  cudaError_t err;
  // Saves the current device and makes `device` current; err is the
  // first call's error (the current device is then unchanged).
  explicit CurrentDevice(int device) : err(cudaGetDevice(&prev)) {
    if (err == cudaSuccess) err = cudaSetDevice(device);
  }
  // The entry may have made other cards current since (a join over
  // several cards): the saved one comes back in every case.
  ~CurrentDevice() {
    if (err == cudaSuccess) cudaSetDevice(prev);
  }
  CurrentDevice(const CurrentDevice&) = delete;
  CurrentDevice& operator=(const CurrentDevice&) = delete;
};
