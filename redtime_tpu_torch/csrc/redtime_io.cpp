// Host IO runtime of redtime_tpu_torch: CAMB transfer-stack parsing and
// output-table formatting (host C++, not a CUDA kernel).
//
// The reference's IO layer is C++ (ifstream parsing in
// AU_cosmological_parameters.h and AU_tabfun.h).  This is the port's copy
// of the JAX package's runtime (csrc/redtime_io.cpp), with its entry points
// and semantics: a strtod table parser bounded to one line, an OpenMP
// reader of a cosmology's transfer stack (33 files x 400-15k rows x 7 or
// 13 columns), and the %20.12g row formatter.  One change: format_rows
// prints every NaN as "nan", as Python's format does, where printf prints
// a NaN with its sign bit set as "-nan".
//
// Built at first use by redtime_tpu_torch/io/native.py
// (g++ -O3 -fPIC -fopenmp -shared) and bound with ctypes there.

#include <cerrno>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Parse a whitespace-separated numeric table, skipping '#' comment lines.
// out must hold max_rows*ncols doubles.  Returns the number of complete
// rows parsed, -1 on IO error, -2 if the buffer filled up with data rows
// still unconsumed (the caller retries with a larger buffer), or -3 if a
// numeric row has fewer than ncols values.  A line with no number is
// skipped; columns past ncols are ignored; CRLF line ends are accepted.
long parse_table(const char *path, long ncols, double *out, long max_rows) {
  FILE *f = fopen(path, "rb");
  if (!f)
    return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 0) {
    fclose(f);
    return -1;
  }
  char *buf = (char *)malloc(size + 1);
  if (!buf) {
    fclose(f);
    return -1;
  }
  if ((long)fread(buf, 1, size, f) != size) {
    free(buf);
    fclose(f);
    return -1;
  }
  buf[size] = '\0';
  fclose(f);

  long rows = 0;
  char *p = buf, *end = buf + size;
  while (p < end && rows < max_rows) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      p++;
    if (p >= end)
      break;
    if (*p == '#') {
      while (p < end && *p != '\n')
        p++;
      continue;
    }
    // one row, bounded to ONE line: bare strtod skips newlines and would
    // merge a short row with the next line(s)
    long c = 0;
    char *q = p;
    for (; c < ncols; c++) {
      while (q < end && (*q == ' ' || *q == '\t' || *q == '\r'))
        q++;
      if (q >= end || *q == '\n' || *q == '#')
        break;
      errno = 0;
      char *next;
      double v = strtod(q, &next);
      if (next == q)
        break;
      out[rows * ncols + c] = v;
      q = next;
    }
    if (c == ncols) {
      rows++;
    } else if (c > 0) {
      free(buf);
      return -3;
    }
    p = q;
    while (p < end && *p != '\n')
      p++;
  }
  if (rows == max_rows) {
    // truncated if any non-comment content remains
    while (p < end) {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
        p++;
      if (p < end && *p == '#') {
        while (p < end && *p != '\n')
          p++;
        continue;
      }
      break;
    }
    if (p < end) {
      free(buf);
      return -2;
    }
  }
  free(buf);
  return rows;
}

// Parse n identically shaped tables, one OpenMP iteration a file.  out
// holds n*max_rows*ncols doubles; rows_out[i] receives parse_table's
// return for file i.
void parse_stack(const char **paths, long n, long ncols, double *out,
                 long max_rows, long *rows_out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (long i = 0; i < n; i++) {
    rows_out[i] = parse_table(paths[i], ncols, out + i * max_rows * ncols,
                              max_rows);
  }
}

// The threads a parallel region started by the calling thread gets, as
// parse_stack's does (1 without OpenMP).
long io_threads(void) {
  long n = 1;
#ifdef _OPENMP
#pragma omp parallel
  {
#pragma omp single
    n = omp_get_num_threads();
  }
#endif
  return n;
}

// Format a [nr, nc] f64 block as the reference's output rows: every value
// printf("%*.*g"), one row per line: the bytes of C++ `setprecision(prec)
// << setw(width)` default-float (redTime.cc:64, :1670-1741) and of
// Python's f"{x:.{prec}g}" right-justified to width (both correctly
// rounded).  Returns the bytes written, or -1 if cap is too small.
long format_rows(const double *data, long nr, long nc, long width,
                 long prec, char *out, long cap) {
  long off = 0;
  for (long i = 0; i < nr; i++) {
    for (long j = 0; j < nc; j++) {
      if (cap - off < width + 40)
        return -1;
      double v = data[i * nc + j];
      int n = std::isnan(v)
                  ? snprintf(out + off, (size_t)(cap - off), "%*s",
                             (int)width, "nan")
                  : snprintf(out + off, (size_t)(cap - off), "%*.*g",
                             (int)width, (int)prec, v);
      if (n < 0)
        return -1;
      off += n;
    }
    if (cap - off < 2)
      return -1;
    out[off++] = '\n';
  }
  return off;
}

} // extern "C"
