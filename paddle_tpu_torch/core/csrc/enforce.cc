// Per-thread error reporting (reference: paddle/common/enforce.cc
// PADDLE_ENFORCE error stack; here a thin C-ABI variant the Python layer
// turns into RuntimeError).
#include "export.h"

#include <string>

namespace pt {
thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }
}  // namespace pt

PT_EXPORT const char* pt_last_error() { return pt::g_last_error.c_str(); }
