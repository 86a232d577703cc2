// Native schedule core: loop-nest enumeration + dependency resolution +
// wavefront leveling for tiled programs.
//
// This is the C++ runtime piece of the static-schedule compiler
// (numpywren_tpu_torch/compiler/schedule.py documents the passes; this file is a
// performance-equivalent implementation for large tile grids, where the
// Python enumerator's per-node interpreter cost dominates compile time —
// e.g. Cholesky at grid 128 is ~360k nodes / ~1.4M edges).
//
// Protocol (all int64 arrays, see native/serialize.py):
//   expressions: postfix bytecode, one stack machine per expression
//   program:     prefix-encoded FOR/IF/CALL tree
//   results:     flat node/read/write/edge/level tables, fetched via
//                handle-based getters (ctypes)
//
// Build: g++ -O2 -shared -fPIC -o _schedule_core.so schedule_core.cpp

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <map>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

using i64 = int64_t;

// ---------------------------------------------------------------- exprs
enum Op : i64 {
  PUSH_CONST = 0, PUSH_VAR = 1, ADD = 2, SUB = 3, MUL = 4, FLOORDIV = 5,
  MOD = 6, POW = 7, NEG = 8, CDIV = 9, MIN2 = 10, MAX2 = 11,
  LT = 12, LE = 13, GT = 14, GE = 15, EQ = 16, NE = 17,
  AND2 = 18, OR2 = 19, NOT1 = 20, ABS1 = 21,
};

inline i64 floordiv(i64 a, i64 b) {
  i64 q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}
inline i64 pymod(i64 a, i64 b) {
  i64 r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
inline i64 ipow(i64 base, i64 exp) {
  i64 r = 1;
  while (exp > 0) {
    if (exp & 1) r *= base;
    base *= base;
    exp >>= 1;
  }
  return r;
}

struct ExprTable {
  // bytecode stream per expression: offsets into one flat array
  std::vector<i64> code;      // pairs (op, arg)
  std::vector<i64> offset;    // per-expr start (in pairs)
  std::vector<i64> length;    // per-expr length (in pairs)

  i64 eval(i64 expr_id, const std::vector<i64>& vars) const {
    thread_local std::vector<i64> stack;
    stack.clear();
    const i64* c = code.data() + 2 * offset[expr_id];
    i64 n = length[expr_id];
    for (i64 i = 0; i < n; ++i) {
      i64 op = c[2 * i], arg = c[2 * i + 1];
      switch (op) {
        case PUSH_CONST: stack.push_back(arg); break;
        case PUSH_VAR: stack.push_back(vars[arg]); break;
        case NEG: stack.back() = -stack.back(); break;
        case NOT1: stack.back() = !stack.back(); break;
        case ABS1: stack.back() = stack.back() < 0 ? -stack.back() : stack.back(); break;
        default: {
          i64 b = stack.back(); stack.pop_back();
          i64 a = stack.back();
          i64 r;
          switch (op) {
            case ADD: r = a + b; break;
            case SUB: r = a - b; break;
            case MUL: r = a * b; break;
            case FLOORDIV: r = floordiv(a, b); break;
            case MOD: r = pymod(a, b); break;
            case POW: r = ipow(a, b); break;
            case CDIV: r = -floordiv(-a, b); break;
            case MIN2: r = a < b ? a : b; break;
            case MAX2: r = a > b ? a : b; break;
            case LT: r = a < b; break;
            case LE: r = a <= b; break;
            case GT: r = a > b; break;
            case GE: r = a >= b; break;
            case EQ: r = a == b; break;
            case NE: r = a != b; break;
            case AND2: r = (a && b); break;
            case OR2: r = (a || b); break;
            default: throw std::runtime_error("bad opcode");
          }
          stack.back() = r;
        }
      }
    }
    return stack.back();
  }
};

// ---------------------------------------------------------------- program
enum StmtTag : i64 { T_FOR = 1, T_IF = 2, T_CALL = 3 };

struct Access {  // one block ref of a CALL
  i64 matrix;    // matrix id
  i64 idx0, idx1, vexpr;  // expr ids for the two phys indices + version (-1)
};

struct Call {
  i64 stmt_id;
  i64 op_id;
  std::vector<i64> loop_slots;      // var slots of enclosing loops
  std::vector<i64> in_kind;         // 0=block, 1=const
  std::vector<Access> reads;        // in in_kind order for blocks
  std::vector<i64> const_exprs;     // in in_kind order for consts
  std::vector<Access> writes;
};

struct Builder;

struct ProgramTree {
  // prefix-encoded stream parsed into an executable tree
  const i64* p;
  i64 n;
  i64 pos = 0;
  ExprTable* exprs;

  i64 next() {
    if (pos >= n) throw std::runtime_error("program stream underrun");
    return p[pos++];
  }
};

struct Node {
  i64 stmt_id, op_id;
  std::vector<i64> var_values;
  // physical addresses: (matrix, i, j, version)
  std::vector<std::array<i64, 4>> reads;
  std::vector<i64> consts;
  std::vector<std::array<i64, 4>> writes;
};

struct Builder {
  ExprTable exprs;
  std::vector<i64> versioned;     // per matrix id
  std::vector<i64> vars;          // slot table
  std::vector<Node> nodes;
  std::string error;

  // edges
  std::vector<std::vector<i64>> parents;
  std::vector<std::vector<i64>> children;
  std::vector<i64> level_of;
  i64 n_levels = 0;
  std::vector<std::array<i64, 3>> initial_reads;  // (matrix, i, j)

  i64 eval(i64 e) { return exprs.eval(e, vars); }

  std::array<i64, 4> resolve(const Access& a) {
    i64 i = eval(a.idx0), j = eval(a.idx1);
    i64 v = a.vexpr >= 0 ? eval(a.vexpr) : -1;
    // pack() gives matrix 7 usable bits (signed <<56), version+1 16, i/j 20
    // each; an out-of-range address would silently alias distinct blocks to
    // one key and corrupt the dependency graph. The "unsupported:" prefix
    // makes the Python driver fall back to the (unbounded) Python passes.
    if (a.matrix < 0 || a.matrix >= 128 || i < 0 || i >= (i64(1) << 20) ||
        j < 0 || j >= (i64(1) << 20) || v < -1 || v + 1 >= (i64(1) << 16)) {
      throw std::runtime_error(
          "unsupported: block address outside packable range (matrix " +
          std::to_string(a.matrix) + ", i " + std::to_string(i) + ", j " +
          std::to_string(j) + ", version " + std::to_string(v) + ")");
    }
    return {a.matrix, i, j, v};
  }

  // --- enumeration over the prefix stream (re-walked per loop iteration
  // would be wasteful: parse once into a tree of closures) ---
  struct Stmt;
  using StmtList = std::vector<Stmt>;
  struct Stmt {
    i64 tag;
    // FOR
    i64 var_slot = 0, e_start = 0, e_stop = 0, e_step = -1;
    StmtList body, orelse;
    // IF
    i64 e_cond = 0;
    // CALL
    Call call;
  };
  StmtList top;

  StmtList parse_list(ProgramTree& t, i64 count) {
    StmtList out;
    out.reserve(count);
    for (i64 s = 0; s < count; ++s) out.push_back(parse_one(t));
    return out;
  }

  Stmt parse_one(ProgramTree& t) {
    Stmt s;
    s.tag = t.next();
    if (s.tag == T_FOR) {
      s.var_slot = t.next();
      s.e_start = t.next();
      s.e_stop = t.next();
      s.e_step = t.next();
      i64 nb = t.next();
      s.body = parse_list(t, nb);
    } else if (s.tag == T_IF) {
      s.e_cond = t.next();
      i64 nt = t.next();
      s.body = parse_list(t, nt);
      i64 ne = t.next();
      s.orelse = parse_list(t, ne);
    } else if (s.tag == T_CALL) {
      Call& c = s.call;
      c.stmt_id = t.next();
      c.op_id = t.next();
      i64 nl = t.next();
      for (i64 i = 0; i < nl; ++i) c.loop_slots.push_back(t.next());
      i64 ni = t.next();
      for (i64 i = 0; i < ni; ++i) {
        i64 kind = t.next();
        c.in_kind.push_back(kind);
        if (kind == 0) {
          Access a;
          a.matrix = t.next(); a.idx0 = t.next(); a.idx1 = t.next(); a.vexpr = t.next();
          c.reads.push_back(a);
        } else {
          c.const_exprs.push_back(t.next());
        }
      }
      i64 no = t.next();
      for (i64 i = 0; i < no; ++i) {
        Access a;
        a.matrix = t.next(); a.idx0 = t.next(); a.idx1 = t.next(); a.vexpr = t.next();
        c.writes.push_back(a);
      }
    } else {
      throw std::runtime_error("bad stmt tag");
    }
    return s;
  }

  void exec_list(const StmtList& list) {
    for (const Stmt& s : list) exec_one(s);
  }

  void exec_one(const Stmt& s) {
    if (s.tag == T_FOR) {
      i64 start = eval(s.e_start), stop = eval(s.e_stop);
      i64 step = s.e_step >= 0 ? eval(s.e_step) : 1;
      if (step > 0) {
        for (i64 v = start; v < stop; v += step) {
          vars[s.var_slot] = v;
          exec_list(s.body);
        }
      } else if (step < 0) {
        for (i64 v = start; v > stop; v += step) {
          vars[s.var_slot] = v;
          exec_list(s.body);
        }
      }
    } else if (s.tag == T_IF) {
      exec_list(eval(s.e_cond) ? s.body : s.orelse);
    } else {
      const Call& c = s.call;
      Node n;
      n.stmt_id = c.stmt_id;
      n.op_id = c.op_id;
      n.var_values.reserve(c.loop_slots.size());
      for (i64 slot : c.loop_slots) n.var_values.push_back(vars[slot]);
      n.reads.reserve(c.reads.size());
      for (const Access& a : c.reads) n.reads.push_back(resolve(a));
      n.consts.reserve(c.const_exprs.size());
      for (i64 e : c.const_exprs) n.consts.push_back(eval(e));
      n.writes.reserve(c.writes.size());
      for (const Access& a : c.writes) n.writes.push_back(resolve(a));
      nodes.push_back(std::move(n));
    }
  }

  // ----------------------------------------------------------- edges
  static i64 pack(const std::array<i64, 4>& a) {
    // matrix(8b) | version+1(16b) | i(20b) | j(20b)
    return (a[0] << 56) | ((a[3] + 1) << 40) | (a[1] << 20) | a[2];
  }

  bool resolve_edges() {
    std::unordered_map<i64, i64> write_map;
    write_map.reserve(nodes.size() * 2);
    for (i64 nid = 0; nid < (i64)nodes.size(); ++nid) {
      for (const auto& w : nodes[nid].writes) {
        auto key = pack(w);
        auto it = write_map.find(key);
        if (it != write_map.end()) {
          error = "double write to block (matrix " + std::to_string(w[0]) +
                  ", " + std::to_string(w[1]) + ", " + std::to_string(w[2]) +
                  ", version " + std::to_string(w[3]) +
                  "); programs must be single-assignment";
          return false;
        }
        write_map.emplace(key, nid);
      }
    }
    i64 n = nodes.size();
    parents.assign(n, {});
    children.assign(n, {});
    std::unordered_map<i64, std::vector<i64>> readers_of;
    std::unordered_map<i64, char> init_seen;

    for (i64 nid = 0; nid < n; ++nid) {
      for (const auto& r : nodes[nid].reads) {
        auto it = write_map.find(pack(r));
        if (it == write_map.end()) {
          if (r[3] > 0 && versioned[r[0]]) {
            error = "node reads version " + std::to_string(r[3]) +
                    " of matrix " + std::to_string(r[0]) + " block (" +
                    std::to_string(r[1]) + "," + std::to_string(r[2]) +
                    "), which nothing writes";
            return false;
          }
          i64 key = (r[0] << 40) | (r[1] << 20) | r[2];
          if (!init_seen.count(key)) {
            init_seen[key] = 1;
            initial_reads.push_back({r[0], r[1], r[2]});
          }
        } else if (it->second == nid) {
          error = "node reads its own output; use a versioned scratch";
          return false;
        } else {
          parents[nid].push_back(it->second);
        }
        if (versioned[r[0]]) readers_of[pack(r)].push_back(nid);
      }
    }
    // WAR: writer of (addr, v) waits for readers of (addr, v-1)
    for (i64 nid = 0; nid < n; ++nid) {
      for (const auto& w : nodes[nid].writes) {
        if (w[3] <= 0) continue;
        std::array<i64, 4> prev = {w[0], w[1], w[2], w[3] - 1};
        auto it = readers_of.find(pack(prev));
        if (it == readers_of.end()) continue;
        for (i64 r : it->second)
          if (r != nid) parents[nid].push_back(r);
      }
    }
    // dedup + children
    for (i64 nid = 0; nid < n; ++nid) {
      auto& p = parents[nid];
      std::sort(p.begin(), p.end());
      p.erase(std::unique(p.begin(), p.end()), p.end());
      for (i64 q : p) children[q].push_back(nid);
    }
    return true;
  }

  bool level() {
    i64 n = nodes.size();
    level_of.assign(n, 0);
    std::vector<i64> indeg(n);
    std::vector<i64> q;
    q.reserve(n);
    for (i64 i = 0; i < n; ++i) {
      indeg[i] = parents[i].size();
      if (!indeg[i]) q.push_back(i);
    }
    i64 seen = 0;
    for (i64 h = 0; h < (i64)q.size(); ++h) {
      i64 nid = q[h];
      ++seen;
      for (i64 c : children[nid]) {
        if (level_of[nid] + 1 > level_of[c]) level_of[c] = level_of[nid] + 1;
        if (--indeg[c] == 0) q.push_back(c);
      }
    }
    if (seen != n) {
      error = "dependency cycle detected in tiled program";
      return false;
    }
    n_levels = 0;
    for (i64 l : level_of) n_levels = std::max(n_levels, l + 1);
    if (n == 0) n_levels = 0;
    return true;
  }
};

std::unordered_map<i64, Builder*> g_handles;
i64 g_next_handle = 1;

}  // namespace

extern "C" {

// Build a schedule. Returns handle > 0, or 0 on error (fetch with get_error).
// expr_code: pairs (op, arg); expr_off/expr_len: per expression (in pairs).
// program: prefix stream. versioned: per-matrix flag. init_vars: slot table
// initial values (consts preloaded; loop slots arbitrary).
i64 npw_build(const i64* expr_code, i64 n_code_pairs,
              const i64* expr_off, const i64* expr_len, i64 n_exprs,
              const i64* program, i64 n_program,
              const i64* versioned, i64 n_matrices,
              const i64* init_vars, i64 n_vars) {
  auto* b = new Builder();
  try {
    b->exprs.code.assign(expr_code, expr_code + 2 * n_code_pairs);
    b->exprs.offset.assign(expr_off, expr_off + n_exprs);
    b->exprs.length.assign(expr_len, expr_len + n_exprs);
    b->versioned.assign(versioned, versioned + n_matrices);
    b->vars.assign(init_vars, init_vars + n_vars);
    ProgramTree t{program, n_program, 0, &b->exprs};
    i64 n_top = t.next();
    b->top = b->parse_list(t, n_top);
    b->exec_list(b->top);
    if (!b->resolve_edges() || !b->level()) {
      // keep builder alive so the error can be fetched; mark handle negative
      i64 h = g_next_handle++;
      g_handles[h] = b;
      return -h;
    }
  } catch (const std::exception& e) {
    b->error = e.what();
    i64 h = g_next_handle++;
    g_handles[h] = b;
    return -h;
  }
  i64 h = g_next_handle++;
  g_handles[h] = b;
  return h;
}

i64 npw_error(i64 handle, char* buf, i64 buflen) {
  auto it = g_handles.find(handle < 0 ? -handle : handle);
  if (it == g_handles.end()) return -1;
  i64 n = std::min<i64>(buflen - 1, it->second->error.size());
  memcpy(buf, it->second->error.data(), n);
  buf[n] = 0;
  return n;
}

i64 npw_num_nodes(i64 h) { return g_handles.at(h)->nodes.size(); }
i64 npw_num_levels(i64 h) { return g_handles.at(h)->n_levels; }
i64 npw_num_initial_reads(i64 h) { return g_handles.at(h)->initial_reads.size(); }

// Sizes needed for caller-allocated buffers.
void npw_sizes(i64 h, i64* out) {
  Builder* b = g_handles.at(h);
  i64 vv = 0, rd = 0, wr = 0, cn = 0, ed = 0;
  for (const auto& n : b->nodes) {
    vv += n.var_values.size();
    rd += n.reads.size();
    wr += n.writes.size();
    cn += n.consts.size();
  }
  for (const auto& p : b->parents) ed += p.size();
  out[0] = vv; out[1] = rd; out[2] = wr; out[3] = cn; out[4] = ed;
}

// Flat node tables. Offsets arrays have length n_nodes+1 (CSR layout).
void npw_nodes(i64 h, i64* stmt, i64* op,
               i64* vv_off, i64* vv,
               i64* rd_off, i64* rd,      // reads: 4 per entry
               i64* wr_off, i64* wr,      // writes: 4 per entry
               i64* cn_off, i64* cn) {
  Builder* b = g_handles.at(h);
  i64 pv = 0, pr = 0, pw = 0, pc = 0;
  for (i64 i = 0; i < (i64)b->nodes.size(); ++i) {
    const Node& n = b->nodes[i];
    stmt[i] = n.stmt_id;
    op[i] = n.op_id;
    vv_off[i] = pv;
    for (i64 v : n.var_values) vv[pv++] = v;
    rd_off[i] = pr;
    for (const auto& a : n.reads) {
      rd[4 * pr] = a[0]; rd[4 * pr + 1] = a[1]; rd[4 * pr + 2] = a[2]; rd[4 * pr + 3] = a[3];
      ++pr;
    }
    wr_off[i] = pw;
    for (const auto& a : n.writes) {
      wr[4 * pw] = a[0]; wr[4 * pw + 1] = a[1]; wr[4 * pw + 2] = a[2]; wr[4 * pw + 3] = a[3];
      ++pw;
    }
    cn_off[i] = pc;
    for (i64 c : n.consts) cn[pc++] = c;
  }
  vv_off[b->nodes.size()] = pv;
  rd_off[b->nodes.size()] = pr;
  wr_off[b->nodes.size()] = pw;
  cn_off[b->nodes.size()] = pc;
}

void npw_edges(i64 h, i64* par_off, i64* par, i64* level_of) {
  Builder* b = g_handles.at(h);
  i64 p = 0;
  for (i64 i = 0; i < (i64)b->nodes.size(); ++i) {
    par_off[i] = p;
    for (i64 q : b->parents[i]) par[p++] = q;
    level_of[i] = b->level_of[i];
  }
  par_off[b->nodes.size()] = p;
}

void npw_initial_reads(i64 h, i64* out) {  // 3 per entry
  Builder* b = g_handles.at(h);
  for (i64 i = 0; i < (i64)b->initial_reads.size(); ++i) {
    out[3 * i] = b->initial_reads[i][0];
    out[3 * i + 1] = b->initial_reads[i][1];
    out[3 * i + 2] = b->initial_reads[i][2];
  }
}

void npw_free(i64 h) {
  auto it = g_handles.find(h < 0 ? -h : h);
  if (it != g_handles.end()) {
    delete it->second;
    g_handles.erase(it);
  }
}

}  // extern "C"
