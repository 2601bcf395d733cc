// Frozen copy of hidegs_tpu_torch/hier/native/hier_builder.cpp:1-417 at commit 63641d3: the benchmark's
// hierarchy builder, compiled by gsbench/scenes/hierarchy.py with the program's flags.
// Offline hierarchy builder — native C++ component.
//
// From-scratch equivalent of the reference's GaussianHierarchyCreator
// pipeline (submodules/gaussianhierarchy): point-based kd-tree over gaussians
// (PointbasedKdTreeGenerator.cpp:16-66 — median split along the widest
// bounds axis), bottom-up cluster merging (ClusterMerger.cpp:23-162 —
// weights w = opacity * ellipseSurface(scale), weighted mean/SH, weighted
// covariance + spread outer products, symmetric 3x3 eigendecomposition into
// merged scale/rotation, merged opacity = weight_sum / surface), and the
// depth-first flattening into the node/box arrays of the .hier format
// (writer.cpp:19-96). No Eigen dependency: the 3x3 symmetric eigensolver is
// a cyclic Jacobi iteration.
//
// Exposed as a C API for ctypes (build_hierarchy / free_hierarchy) and as a
// CLI (read .ply-extracted raw arrays, write .hier) via main() when compiled
// with -DHIER_BUILDER_MAIN.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libhier_builder.so hier_builder.cpp

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int SH_FLOATS = 48;

struct Vec3 {
  float x = 0, y = 0, z = 0;
  float operator[](int i) const { return (&x)[i]; }
  float& operator[](int i) { return (&x)[i]; }
};
static Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Gaussian {
  Vec3 position;
  float rotation[4];  // wxyz
  Vec3 scale;         // linear (activated)
  float opacity;      // activated
  float shs[SH_FLOATS];
  float cov[6];  // xx xy xz yy yz zz
};

struct Node {
  int depth = -1, parent = -1, start = 0, count_leafs = 0, count_merged = 0,
      start_children = -1, count_children = 0;
};

struct Box {
  float minn[4] = {0, 0, 0, 0};
  float maxx[4] = {0, 0, 0, 0};
};

struct TreeNode {
  int depth = 0;
  Box bounds;
  std::vector<int> leaf_indices;
  std::vector<Gaussian> merged;
  std::vector<TreeNode*> children;
  ~TreeNode() {
    for (auto* c : children) delete c;
  }
};

static float ellipse_surface(const Vec3& s) {
  return s.x * s.y + s.x * s.z + s.y * s.z;
}

// quat (wxyz) + scale → covariance 6-vector (matches core/transforms.py)
static void gaussian_cov(Gaussian& g) {
  float w = g.rotation[0], x = g.rotation[1], y = g.rotation[2], z = g.rotation[3];
  float n = std::sqrt(w * w + x * x + y * y + z * z);
  if (n < 1e-12f) n = 1.f;
  w /= n; x /= n; y /= n; z /= n;
  float R[3][3] = {
      {1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)},
      {2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)},
      {2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)}};
  float M[3][3];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) M[i][j] = R[i][j] * g.scale[j];
  float C[3][3];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      C[i][j] = 0;
      for (int k = 0; k < 3; k++) C[i][j] += M[i][k] * M[j][k];
    }
  g.cov[0] = C[0][0]; g.cov[1] = C[1][0]; g.cov[2] = C[2][0];
  g.cov[3] = C[1][1]; g.cov[4] = C[2][1]; g.cov[5] = C[2][2];
}

// Symmetric 3x3 eigendecomposition (cyclic Jacobi). A is overwritten;
// eigvals ascending in d, eigvecs in columns of V.
static void eig_sym3(float A[3][3], float d[3], float V[3][3]) {
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) V[i][j] = (i == j) ? 1.f : 0.f;
  for (int sweep = 0; sweep < 24; sweep++) {
    float off = std::fabs(A[0][1]) + std::fabs(A[0][2]) + std::fabs(A[1][2]);
    if (off < 1e-12f) break;
    for (int p = 0; p < 2; p++)
      for (int q = p + 1; q < 3; q++) {
        if (std::fabs(A[p][q]) < 1e-15f) continue;
        float theta = (A[q][q] - A[p][p]) / (2.f * A[p][q]);
        float t = (theta >= 0 ? 1.f : -1.f) /
                  (std::fabs(theta) + std::sqrt(theta * theta + 1.f));
        float c = 1.f / std::sqrt(t * t + 1.f);
        float s = t * c;
        for (int k = 0; k < 3; k++) {
          float Akp = A[k][p], Akq = A[k][q];
          A[k][p] = c * Akp - s * Akq;
          A[k][q] = s * Akp + c * Akq;
        }
        for (int k = 0; k < 3; k++) {
          float Apk = A[p][k], Aqk = A[q][k];
          A[p][k] = c * Apk - s * Aqk;
          A[q][k] = s * Apk + c * Aqk;
        }
        for (int k = 0; k < 3; k++) {
          float Vkp = V[k][p], Vkq = V[k][q];
          V[k][p] = c * Vkp - s * Vkq;
          V[k][q] = s * Vkp + c * Vkq;
        }
      }
  }
  int order[3] = {0, 1, 2};
  float ev[3] = {A[0][0], A[1][1], A[2][2]};
  std::sort(order, order + 3, [&](int a, int b) { return ev[a] < ev[b]; });
  float Vt[3][3];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) Vt[i][j] = V[i][order[j]];
  for (int j = 0; j < 3; j++) d[j] = ev[order[j]];
  std::memcpy(V, Vt, sizeof(Vt));
}

// rotation matrix (columns = axes) → quaternion wxyz (Shepperd)
static void quat_from_mat(const float R[3][3], float q[4]) {
  float tr = R[0][0] + R[1][1] + R[2][2];
  if (tr > 0) {
    float s = std::sqrt(tr + 1.f) * 2.f;
    q[0] = 0.25f * s;
    q[1] = (R[2][1] - R[1][2]) / s;
    q[2] = (R[0][2] - R[2][0]) / s;
    q[3] = (R[1][0] - R[0][1]) / s;
  } else if (R[0][0] > R[1][1] && R[0][0] > R[2][2]) {
    float s = std::sqrt(1.f + R[0][0] - R[1][1] - R[2][2]) * 2.f;
    q[0] = (R[2][1] - R[1][2]) / s;
    q[1] = 0.25f * s;
    q[2] = (R[0][1] + R[1][0]) / s;
    q[3] = (R[0][2] + R[2][0]) / s;
  } else if (R[1][1] > R[2][2]) {
    float s = std::sqrt(1.f + R[1][1] - R[0][0] - R[2][2]) * 2.f;
    q[0] = (R[0][2] - R[2][0]) / s;
    q[1] = (R[0][1] + R[1][0]) / s;
    q[2] = 0.25f * s;
    q[3] = (R[1][2] + R[2][1]) / s;
  } else {
    float s = std::sqrt(1.f + R[2][2] - R[0][0] - R[1][1]) * 2.f;
    q[0] = (R[1][0] - R[0][1]) / s;
    q[1] = (R[0][2] + R[2][0]) / s;
    q[2] = (R[1][2] + R[2][1]) / s;
    q[3] = 0.25f * s;
  }
}

// ---- kd-tree (PointbasedKdTreeGenerator.cpp:16-66) ------------------------

static TreeNode* rec_kdtree(const std::vector<Gaussian>& gs, int* idx, int start,
                            int num) {
  auto* node = new TreeNode;
  Vec3 mn = {FLT_MAX, FLT_MAX, FLT_MAX}, mx = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int i = 0; i < num; i++) {
    const Gaussian& g = gs[idx[start + i]];
    float r = 3.f * std::max(g.scale.x, std::max(g.scale.y, g.scale.z));
    mn = vmin(mn, {g.position.x - r, g.position.y - r, g.position.z - r});
    mx = vmax(mx, {g.position.x + r, g.position.y + r, g.position.z + r});
  }
  node->bounds.minn[0] = mn.x; node->bounds.minn[1] = mn.y; node->bounds.minn[2] = mn.z;
  node->bounds.maxx[0] = mx.x; node->bounds.maxx[1] = mx.y; node->bounds.maxx[2] = mx.z;

  if (num == 1) {
    node->depth = 0;
    node->leaf_indices.push_back(idx[start]);
    return node;
  }
  int axis = 0;
  float best = 0;
  for (int i = 0; i < 3; i++) {
    float d = mx[i] - mn[i];
    if (d > best) { best = d; axis = i; }
  }
  int pivot = num / 2 - 1;
  std::nth_element(idx + start, idx + start + pivot, idx + start + num,
                   [&](int a, int b) { return gs[a].position[axis] < gs[b].position[axis]; });
  node->children.push_back(rec_kdtree(gs, idx, start, pivot + 1));
  node->children.push_back(rec_kdtree(gs, idx, start + pivot + 1, num - (pivot + 1)));
  node->depth = std::max(node->children[0]->depth, node->children[1]->depth) + 1;
  return node;
}

// ---- bottom-up cluster merge (ClusterMerger.cpp:23-162) --------------------

static void merge_rec(TreeNode* node, const std::vector<Gaussian>& leaves) {
  std::vector<const Gaussian*> to_merge;
  for (auto* c : node->children) {
    merge_rec(c, leaves);
    if (!c->merged.empty()) to_merge.push_back(&c->merged[0]);
    for (int li : c->leaf_indices) to_merge.push_back(&leaves[li]);
  }
  if (node->depth == 0) {
    // leaf: granularity = max box extent
    float dx = node->bounds.maxx[0] - node->bounds.minn[0];
    float dy = node->bounds.maxx[1] - node->bounds.minn[1];
    float dz = node->bounds.maxx[2] - node->bounds.minn[2];
    float gran = std::max(dx, std::max(dy, dz));
    node->bounds.minn[3] = gran;
    node->bounds.maxx[3] = gran;
    return;
  }

  Gaussian m{};
  float weight_sum = 0;
  std::vector<float> ws(to_merge.size());
  for (size_t i = 0; i < to_merge.size(); i++) {
    ws[i] = to_merge[i]->opacity * ellipse_surface(to_merge[i]->scale);
    weight_sum += ws[i];
  }
  float inv = weight_sum > 0 ? 1.f / weight_sum : 0.f;
  for (auto& w : ws) w *= inv;

  for (size_t i = 0; i < to_merge.size(); i++) {
    const Gaussian* g = to_merge[i];
    for (int k = 0; k < 3; k++) m.position[k] += ws[i] * g->position[k];
    for (int k = 0; k < SH_FLOATS; k++) m.shs[k] += ws[i] * g->shs[k];
  }
  for (size_t i = 0; i < to_merge.size(); i++) {
    const Gaussian* g = to_merge[i];
    float dx = g->position.x - m.position.x;
    float dy = g->position.y - m.position.y;
    float dz = g->position.z - m.position.z;
    m.cov[0] += ws[i] * (g->cov[0] + dx * dx);
    m.cov[1] += ws[i] * (g->cov[1] + dy * dx);
    m.cov[2] += ws[i] * (g->cov[2] + dz * dx);
    m.cov[3] += ws[i] * (g->cov[3] + dy * dy);
    m.cov[4] += ws[i] * (g->cov[4] + dz * dy);
    m.cov[5] += ws[i] * (g->cov[5] + dz * dz);
  }

  float A[3][3] = {{m.cov[0], m.cov[1], m.cov[2]},
                   {m.cov[1], m.cov[3], m.cov[4]},
                   {m.cov[2], m.cov[4], m.cov[5]}};
  // regularize zero eigenvalues like the reference (ClusterMerger.cpp:98-110)
  for (int k = 0; k < 3; k++)
    A[k][k] += std::max(A[k][k] * 1e-4f, FLT_EPSILON);
  float d[3], V[3][3];
  eig_sym3(A, d, V);
  // right-handed basis
  float c2[3] = {V[1][0] * V[2][1] - V[2][0] * V[1][1],
                 V[2][0] * V[0][1] - V[0][0] * V[2][1],
                 V[0][0] * V[1][1] - V[1][0] * V[0][1]};
  float dot = c2[0] * V[0][2] + c2[1] * V[1][2] + c2[2] * V[2][2];
  if (dot < 0)
    for (int k = 0; k < 3; k++) V[k][2] = -V[k][2];

  m.scale = {std::sqrt(std::fabs(d[0])), std::sqrt(std::fabs(d[1])),
             std::sqrt(std::fabs(d[2]))};
  quat_from_mat(V, m.rotation);
  m.opacity = weight_sum / std::max(ellipse_surface(m.scale), 1e-20f);
  m.opacity = std::min(m.opacity, 1.0f);

  node->merged.push_back(m);

  // granularity from the merged primitive's box extent
  float dx = node->bounds.maxx[0] - node->bounds.minn[0];
  float dy = node->bounds.maxx[1] - node->bounds.minn[1];
  float dz = node->bounds.maxx[2] - node->bounds.minn[2];
  float gran = std::max(dx, std::max(dy, dz));
  node->bounds.minn[3] = gran;
  node->bounds.maxx[3] = gran;
}

// ---- flatten (writer.cpp:19-84) -------------------------------------------

struct FlatOut {
  std::vector<float> pos, rot, logscale, alpha, shs;
  std::vector<Node> nodes;
  std::vector<Box> boxes;
};

static void populate_rec(const TreeNode* tn, int id, const std::vector<Gaussian>& gs,
                         FlatOut& out) {
  out.boxes[id] = tn->bounds;
  out.nodes[id].start = (int)(out.pos.size() / 3);
  auto push = [&](const Gaussian& g) {
    out.pos.insert(out.pos.end(), {g.position.x, g.position.y, g.position.z});
    out.rot.insert(out.rot.end(), {g.rotation[0], g.rotation[1], g.rotation[2], g.rotation[3]});
    out.logscale.insert(out.logscale.end(),
                        {std::log(std::max(g.scale.x, 1e-20f)),
                         std::log(std::max(g.scale.y, 1e-20f)),
                         std::log(std::max(g.scale.z, 1e-20f))});
    out.alpha.push_back(g.opacity);
    out.shs.insert(out.shs.end(), g.shs, g.shs + SH_FLOATS);
  };
  for (int li : tn->leaf_indices) push(gs[li]);
  out.nodes[id].count_leafs = (int)tn->leaf_indices.size();
  for (auto& g : tn->merged) push(g);
  out.nodes[id].count_merged = (int)tn->merged.size();
  out.nodes[id].start_children = (int)out.nodes.size();
  for (size_t n = 0; n < tn->children.size(); n++) {
    out.nodes.emplace_back();
    out.nodes.back().parent = id;
    out.boxes.emplace_back();
  }
  out.nodes[id].count_children = (int)tn->children.size();
  out.nodes[id].depth = tn->depth;
  int sc = out.nodes[id].start_children;
  for (size_t n = 0; n < tn->children.size(); n++)
    populate_rec(tn->children[n], sc + (int)n, gs, out);
}

}  // namespace

// ---- C API ----------------------------------------------------------------

extern "C" {

struct HierResult {
  int num_points;
  int num_nodes;
  float* pos;       // P*3
  float* rot;       // P*4
  float* log_scale; // P*3
  float* alpha;     // P
  float* shs;       // P*48
  int* nodes;       // N*7
  float* boxes;     // N*8
};

// Inputs are LEAF gaussians: pos P*3, rot P*4 (wxyz), scale P*3 (LINEAR,
// activated), alpha P (activated opacity), shs P*48 ([dc3, rest45]).
// NaN/Inf gaussians are dropped (mainHierarchyCreator.cpp:73-128).
HierResult* build_hierarchy(int P, const float* pos, const float* rot,
                            const float* scale, const float* alpha,
                            const float* shs) {
  std::vector<Gaussian> gs;
  gs.reserve(P);
  for (int i = 0; i < P; i++) {
    Gaussian g{};
    g.position = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
    for (int k = 0; k < 4; k++) g.rotation[k] = rot[4 * i + k];
    g.scale = {scale[3 * i], scale[3 * i + 1], scale[3 * i + 2]};
    g.opacity = alpha[i];
    std::memcpy(g.shs, shs + SH_FLOATS * i, SH_FLOATS * sizeof(float));
    bool ok = true;
    for (int k = 0; k < 3 && ok; k++)
      ok = std::isfinite(g.position[k]) && std::isfinite(g.scale[k]);
    ok = ok && std::isfinite(g.opacity);
    if (!ok) continue;
    gaussian_cov(g);
    gs.push_back(g);
  }
  if (gs.empty()) return nullptr;

  std::vector<int> idx(gs.size());
  for (size_t i = 0; i < idx.size(); i++) idx[i] = (int)i;
  TreeNode* root = rec_kdtree(gs, idx.data(), 0, (int)gs.size());
  merge_rec(root, gs);

  FlatOut out;
  out.nodes.resize(1);
  out.boxes.resize(1);
  populate_rec(root, 0, gs, out);
  delete root;

  auto* r = new HierResult;
  r->num_points = (int)(out.pos.size() / 3);
  r->num_nodes = (int)out.nodes.size();
  auto dup = [](const auto& v) {
    using T = typename std::decay_t<decltype(v)>::value_type;
    T* p = (T*)std::malloc(v.size() * sizeof(T));
    std::memcpy(p, v.data(), v.size() * sizeof(T));
    return p;
  };
  r->pos = dup(out.pos);
  r->rot = dup(out.rot);
  r->log_scale = dup(out.logscale);
  r->alpha = dup(out.alpha);
  r->shs = dup(out.shs);
  r->nodes = (int*)std::malloc(out.nodes.size() * sizeof(Node));
  std::memcpy(r->nodes, out.nodes.data(), out.nodes.size() * sizeof(Node));
  r->boxes = (float*)std::malloc(out.boxes.size() * sizeof(Box));
  std::memcpy(r->boxes, out.boxes.data(), out.boxes.size() * sizeof(Box));
  return r;
}

void free_hierarchy(HierResult* r) {
  if (!r) return;
  std::free(r->pos);
  std::free(r->rot);
  std::free(r->log_scale);
  std::free(r->alpha);
  std::free(r->shs);
  std::free(r->nodes);
  std::free(r->boxes);
  delete r;
}

}  // extern "C"
