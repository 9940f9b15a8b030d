// Native decode of a serving replica's POST /predict body (host C++17, no
// GPU code).  Built by ops/_build.py with the host compiler
//
//     c++ -O3 -std=c++17 -shared -fPIC -o build/dist_svgd_torch/libpredict_body-<hash>.so
//
// and loaded with ctypes.CDLL, which releases the interpreter lock for the
// call: the batcher's lane runs while a handler thread decodes.
//
// The result is bitwise what the JAX server computes from the same bytes,
//
//     np.asarray(json.loads(body)["inputs"], dtype=np.float32)
//
// (reshaped to one row when "inputs" is flat), because each number takes
// the same two roundings: its text to the nearest double (Python's float(),
// here std::from_chars), then that double to the nearest float32 (numpy's
// cast, here a C cast).  Integers of at most 15 digits are exact in a
// double, so their one rounding is numpy's; a longer one is declined.
//
// The decoder accepts exactly one shape of body: after optional JSON
// whitespace, an object with the key "inputs" (a non-empty rectangular
// array of JSON numbers, one or two levels deep) and optionally the key
// "tenant" (a string of printable ASCII with no escapes), in either order,
// then only whitespace.  Anything else is declined: other keys, duplicate
// keys, escapes, NaN / Infinity, any token strict JSON rejects, ragged or
// empty rows, more than 15 integer digits.  A declined body returns 0 and
// the caller decodes it as the JAX server does, so its answer (a 400 and
// its message, or a result) stays the reference's.

#include <charconv>
#include <cstdint>
#include <cstring>
#include <limits>
#include <system_error>

namespace {

struct Cursor {
  const char* p;
  const char* end;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }
  bool eat(char c) {
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    return false;
  }
  bool digit() const { return p < end && *p >= '0' && *p <= '9'; }
};

// Scans one string after its opening quote; [*start, *start + *len) is its
// text.  Only printable ASCII without a backslash is accepted.
bool scan_string(Cursor& c, const char** start, int64_t* len) {
  const char* s = c.p;
  while (c.p < c.end && *c.p != '"') {
    unsigned char b = static_cast<unsigned char>(*c.p);
    if (b < 0x20 || b > 0x7e || b == '\\') return false;
    ++c.p;
  }
  if (c.p == c.end) return false;
  *start = s;
  *len = c.p - s;
  ++c.p;  // the closing quote
  return true;
}

// A value that std::from_chars reports out of a double's range: +-inf when
// its decimal magnitude is large, +-0 when it is tiny.  Either way the
// float32 cast of Python's double gives the same value, since every double
// past float32's range casts to +-inf and every subnormal double to +-0.
float out_of_range(const char* s, const char* e) {
  bool neg = *s == '-';
  if (neg) ++s;
  bool seen = false, frac = false;
  int64_t int_digits = 0, zeros = 0;
  for (; s < e && *s != 'e' && *s != 'E'; ++s) {
    if (*s == '.') {
      frac = true;
      continue;
    }
    if (!seen && *s == '0') {
      if (frac) ++zeros;
      continue;
    }
    seen = true;
    if (!frac) ++int_digits;
  }
  // the decimal position of the first non-zero digit
  int64_t lead = int_digits > 0 ? int_digits : -zeros;
  int64_t exp10 = 0;
  if (s < e) {
    ++s;
    bool eneg = *s == '-';
    if (*s == '-' || *s == '+') ++s;
    for (; s < e; ++s) {
      if (exp10 < 1000000000) exp10 = exp10 * 10 + (*s - '0');
    }
    if (eneg) exp10 = -exp10;
  }
  float v = lead + exp10 > 0 ? std::numeric_limits<float>::infinity() : 0.0f;
  return neg ? -v : v;
}

// Scans one JSON number and stores its float32.
bool scan_number(Cursor& c, float* out) {
  const char* s = c.p;
  c.eat('-');
  const char* first = c.p;
  if (c.eat('0')) {
  } else if (c.digit()) {
    while (c.digit()) ++c.p;
  } else {
    return false;
  }
  int64_t int_digits = c.p - first;
  bool integer = true;
  if (c.eat('.')) {
    integer = false;
    if (!c.digit()) return false;
    while (c.digit()) ++c.p;
  }
  if (c.p < c.end && (*c.p == 'e' || *c.p == 'E')) {
    ++c.p;
    integer = false;
    if (!c.eat('+')) c.eat('-');
    if (!c.digit()) return false;
    while (c.digit()) ++c.p;
  }
  if (integer) {
    if (int_digits > 15) return false;
    int64_t v = 0;
    for (const char* q = first; q < c.p; ++q) v = v * 10 + (*q - '0');
    // a Python int has no -0: "-0" is 0, whose float32 is +0
    if (*s == '-') v = -v;
    *out = v == 0 ? 0.0f : static_cast<float>(static_cast<double>(v));
    return true;
  }
  double d = 0.0;
  std::from_chars_result r = std::from_chars(s, c.p, d);
  if (r.ec == std::errc::result_out_of_range) {
    *out = out_of_range(s, c.p);
  } else if (r.ec != std::errc() || r.ptr != c.p) {
    return false;
  } else {
    *out = static_cast<float>(d);
  }
  return true;
}

// Scans a non-empty array of numbers after its opening bracket, through
// its closing one; *count is how many it held.
bool scan_row(Cursor& c, float* out, int64_t cap, int64_t* filled, int64_t* count) {
  int64_t n = 0;
  for (;;) {
    c.ws();
    if (*filled >= cap) return false;
    if (!scan_number(c, out + *filled)) return false;
    ++*filled;
    ++n;
    c.ws();
    if (c.eat(']')) break;
    if (!c.eat(',')) return false;
  }
  *count = n;
  return true;
}

// Scans the value of "inputs": one row, or a non-empty list of rows of one
// length.
bool scan_inputs(Cursor& c, float* out, int64_t cap, int64_t* rows, int64_t* cols) {
  if (!c.eat('[')) return false;
  c.ws();
  int64_t filled = 0;
  if (!c.eat('[')) {
    *rows = 1;
    return scan_row(c, out, cap, &filled, cols);
  }
  int64_t r = 0, width = -1;
  for (;;) {
    int64_t n = 0;
    if (!scan_row(c, out, cap, &filled, &n)) return false;
    if (width >= 0 && n != width) return false;
    width = n;
    ++r;
    c.ws();
    if (c.eat(']')) break;
    if (!c.eat(',')) return false;
    c.ws();
    if (!c.eat('[')) return false;
  }
  *rows = r;
  *cols = width;
  return true;
}

}  // namespace

extern "C" {

// Decodes body[0:len].  Returns 1 when the body has the accepted shape and
// 0 when it is declined.  On 1: shape[0], shape[1] are the rows and
// columns (one row for a flat "inputs"), out[0 : rows * cols] holds the
// values row-major (cap floats are writable; a body holds at most
// len / 2 + 1 numbers), and tenant[0], tenant[1] are the offset and length
// of the "tenant" string in body, or -1, 0 without one.
int predict_body_decode(const char* body, int64_t len, float* out, int64_t cap,
                        int64_t* shape, int64_t* tenant) {
  Cursor c{body, body + len};
  bool have_inputs = false, have_tenant = false;
  int64_t rows = 0, cols = 0;
  tenant[0] = -1;
  tenant[1] = 0;
  c.ws();
  if (!c.eat('{')) return 0;
  for (;;) {
    c.ws();
    if (!c.eat('"')) return 0;
    const char* key = nullptr;
    int64_t key_len = 0;
    if (!scan_string(c, &key, &key_len)) return 0;
    c.ws();
    if (!c.eat(':')) return 0;
    c.ws();
    if (key_len == 6 && std::memcmp(key, "inputs", 6) == 0) {
      if (have_inputs) return 0;
      have_inputs = true;
      if (!scan_inputs(c, out, cap, &rows, &cols)) return 0;
    } else if (key_len == 6 && std::memcmp(key, "tenant", 6) == 0) {
      if (have_tenant) return 0;
      have_tenant = true;
      if (!c.eat('"')) return 0;
      const char* s = nullptr;
      int64_t n = 0;
      if (!scan_string(c, &s, &n)) return 0;
      tenant[0] = s - body;
      tenant[1] = n;
    } else {
      return 0;
    }
    c.ws();
    if (c.eat('}')) break;
    if (!c.eat(',')) return 0;
  }
  c.ws();
  if (c.p != c.end || !have_inputs) return 0;
  shape[0] = rows;
  shape[1] = cols;
  return 1;
}

}  // extern "C"
