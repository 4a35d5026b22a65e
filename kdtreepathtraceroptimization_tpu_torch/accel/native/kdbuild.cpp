// Native KD-tree builder.
//
// The port's copy of the JAX package's accel/native/kdbuild.cpp: the C++
// twin of the numpy builder in accel/kdtree.py (the reference's host
// build, src/KDnode.cpp:151-249: spatial-median split at the bbox center,
// axis = level % 3, straddler duplication with +/-1e-4 slack, no-progress
// guard, 0.001 bbox pad), emitting the same flat layout: DFS pre-order
// nodes with the left child at id + 1 and precomputed skip links, plus the
// leaf-contiguous triangle order.
//
// Its arrays equal the numpy builder's bit for bit (the tests assert it);
// it exists because the host build time matters at 100k-triangle scale.
//
// C ABI (ctypes): build -> opaque handle -> size queries -> export into
// caller-allocated numpy buffers -> free.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BuildEntry {
    std::vector<int64_t> tris;
    float bmin[3];
    float bmax[3];
    int level;
    int parent;
    bool is_right;
};

struct KdResult {
    std::vector<int32_t> axis;
    std::vector<float> split_pos;
    std::vector<float> bbox_min;  // 3*M
    std::vector<float> bbox_max;  // 3*M
    std::vector<int32_t> left, right, skip, parent;
    std::vector<int32_t> tri_start, tri_count;
    std::vector<int64_t> tri_order;  // leaf-contiguous original indices
    int max_depth_seen = 0;
    float root_min[3] = {0, 0, 0}, root_max[3] = {0, 0, 0};
};

}  // namespace

extern "C" {

void* kd_build(const float* tri_min, const float* tri_max, int64_t n_tris,
               int leaf_size, int max_depth, float slack, float pad) {
    KdResult* out = new KdResult();

    if (n_tris > 0) {
        for (int c = 0; c < 3; ++c) {
            float mn = tri_min[c], mx = tri_max[c];
            for (int64_t i = 1; i < n_tris; ++i) {
                mn = tri_min[3 * i + c] < mn ? tri_min[3 * i + c] : mn;
                mx = tri_max[3 * i + c] > mx ? tri_max[3 * i + c] : mx;
            }
            out->root_min[c] = mn - pad;
            out->root_max[c] = mx + pad;
        }
    }

    std::vector<BuildEntry> stack;
    if (n_tris > 0) {
        BuildEntry root;
        root.tris.resize(n_tris);
        for (int64_t i = 0; i < n_tris; ++i) root.tris[i] = i;
        std::memcpy(root.bmin, out->root_min, sizeof root.bmin);
        std::memcpy(root.bmax, out->root_max, sizeof root.bmax);
        root.level = 0;
        root.parent = -1;
        root.is_right = false;
        stack.push_back(std::move(root));
    }

    while (!stack.empty()) {
        BuildEntry e = std::move(stack.back());
        stack.pop_back();

        int node_id = static_cast<int>(out->axis.size());
        out->axis.push_back(-1);
        out->split_pos.push_back(0.0f);
        for (int c = 0; c < 3; ++c) out->bbox_min.push_back(e.bmin[c]);
        for (int c = 0; c < 3; ++c) out->bbox_max.push_back(e.bmax[c]);
        out->left.push_back(-1);
        out->right.push_back(-1);
        out->skip.push_back(-1);  // fixed up later
        out->parent.push_back(e.parent);
        out->tri_start.push_back(0);
        out->tri_count.push_back(0);
        if (e.level > out->max_depth_seen) out->max_depth_seen = e.level;
        if (e.parent >= 0) {
            if (e.is_right)
                out->right[e.parent] = node_id;
            else
                out->left[e.parent] = node_id;
        }

        const int64_t num = static_cast<int64_t>(e.tris.size());
        bool make_leaf = num <= leaf_size || e.level > max_depth;
        int ax = e.level % 3;
        float center = 0.5f * (e.bmin[ax] + e.bmax[ax]);
        std::vector<int64_t> left_tris, right_tris;
        if (!make_leaf) {
            left_tris.reserve(num);
            right_tris.reserve(num);
            for (int64_t idx : e.tris) {
                if (tri_min[3 * idx + ax] < center + slack) left_tris.push_back(idx);
                if (tri_max[3 * idx + ax] >= center - slack) right_tris.push_back(idx);
            }
            // no-progress guard (reference KDnode.cpp:190)
            if ((int64_t)left_tris.size() == num || (int64_t)right_tris.size() == num)
                make_leaf = true;
            // bad-split guard (matches the numpy builder): nearly all
            // triangles straddling means the split only duplicates.
            else if ((double)left_tris.size() >= 0.95 * (double)num &&
                     (double)right_tris.size() >= 0.95 * (double)num)
                make_leaf = true;
        }

        if (make_leaf) {
            out->tri_start[node_id] = static_cast<int32_t>(out->tri_order.size());
            out->tri_count[node_id] = static_cast<int32_t>(num);
            out->tri_order.insert(out->tri_order.end(), e.tris.begin(), e.tris.end());
            continue;
        }

        out->axis[node_id] = ax;
        out->split_pos[node_id] = center;

        // Push right first so the left child is emitted next (pre-order
        // with left = id + 1).
        if (!right_tris.empty()) {
            BuildEntry r;
            r.tris = std::move(right_tris);
            std::memcpy(r.bmin, e.bmin, sizeof r.bmin);
            std::memcpy(r.bmax, e.bmax, sizeof r.bmax);
            r.bmin[ax] = center;
            r.level = e.level + 1;
            r.parent = node_id;
            r.is_right = true;
            stack.push_back(std::move(r));
        }
        if (!left_tris.empty()) {
            BuildEntry l;
            l.tris = std::move(left_tris);
            std::memcpy(l.bmin, e.bmin, sizeof l.bmin);
            std::memcpy(l.bmax, e.bmax, sizeof l.bmax);
            l.bmax[ax] = center;
            l.level = e.level + 1;
            l.parent = node_id;
            l.is_right = false;
            stack.push_back(std::move(l));
        }
    }

    // Skip links (same recurrence as the numpy builder): skip(left) =
    // right sibling else skip(parent); skip(right) = skip(parent);
    // skip(root) = M.
    const int m = static_cast<int>(out->axis.size());
    for (int i = 0; i < m; ++i) out->skip[i] = m;
    for (int i = 0; i < m; ++i) {
        int l = out->left[i], r = out->right[i];
        if (l >= 0) out->skip[l] = (r >= 0) ? r : out->skip[i];
        if (r >= 0) out->skip[r] = out->skip[i];
    }

    return out;
}

int64_t kd_node_count(void* h) { return static_cast<KdResult*>(h)->axis.size(); }
int64_t kd_tri_count(void* h) { return static_cast<KdResult*>(h)->tri_order.size(); }
int32_t kd_max_depth(void* h) { return static_cast<KdResult*>(h)->max_depth_seen; }

void kd_export(void* h, int32_t* axis, float* split_pos, float* bbox_min,
               float* bbox_max, int32_t* left, int32_t* right, int32_t* skip,
               int32_t* parent, int32_t* tri_start, int32_t* tri_count,
               int64_t* tri_order, float* root_min, float* root_max) {
    KdResult* r = static_cast<KdResult*>(h);
    const size_t m = r->axis.size();
    std::memcpy(axis, r->axis.data(), m * sizeof(int32_t));
    std::memcpy(split_pos, r->split_pos.data(), m * sizeof(float));
    std::memcpy(bbox_min, r->bbox_min.data(), 3 * m * sizeof(float));
    std::memcpy(bbox_max, r->bbox_max.data(), 3 * m * sizeof(float));
    std::memcpy(left, r->left.data(), m * sizeof(int32_t));
    std::memcpy(right, r->right.data(), m * sizeof(int32_t));
    std::memcpy(skip, r->skip.data(), m * sizeof(int32_t));
    std::memcpy(parent, r->parent.data(), m * sizeof(int32_t));
    std::memcpy(tri_start, r->tri_start.data(), m * sizeof(int32_t));
    std::memcpy(tri_count, r->tri_count.data(), m * sizeof(int32_t));
    std::memcpy(tri_order, r->tri_order.data(), r->tri_order.size() * sizeof(int64_t));
    std::memcpy(root_min, r->root_min, 3 * sizeof(float));
    std::memcpy(root_max, r->root_max, 3 * sizeof(float));
}

void kd_free(void* h) { delete static_cast<KdResult*>(h); }

}  // extern "C"
