// Grid min-cut (max-flow) on a 4-connected image grid — host-side native
// backend and test oracle for the device push-relabel solver
// (simplepanorama_tpu/ops/maxflow.py).
//
// The reference application vendors the Boykov-Kolmogorov library for this
// role (/root/reference/src/max_flow/). This is NOT that code: it is a
// from-scratch Dinic implementation (BFS level graph + DFS blocking flow),
// specialized to the 4-connected grid with terminal links folded into a
// signed per-node excess, exactly the graph encoding the device solver uses.
// Exact on the same graph, so cut values can be compared bit-for-bit
// against the data-parallel solver.
//
// C ABI (ctypes):
//   grid_mincut(H, W, cap_h, cap_v, excess, node, out_labels)
//     cap_h[y*W+x]: capacity (y,x)<->(y,x+1); cap_v: (y,x)<->(y+1,x)
//     excess: + = source link, - = sink link; node: 0/1 validity
//     out_labels: 1 where the node is on the SOURCE side of a min cut.

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Edge {
    int to;
    int rev;      // index of reverse edge in edges[to]
    float cap;
};

struct Graph {
    std::vector<std::vector<Edge>> edges;
    std::vector<int> level, iter;

    explicit Graph(int n) : edges(n), level(n), iter(n) {}

    void add_edge(int a, int b, float cab, float cba) {
        edges[a].push_back({b, (int)edges[b].size(), cab});
        edges[b].push_back({a, (int)edges[a].size() - 1, cba});
    }

    bool bfs(int s, int t) {
        std::fill(level.begin(), level.end(), -1);
        std::queue<int> q;
        level[s] = 0;
        q.push(s);
        while (!q.empty()) {
            int v = q.front();
            q.pop();
            for (const Edge& e : edges[v]) {
                if (e.cap > 0 && level[e.to] < 0) {
                    level[e.to] = level[v] + 1;
                    q.push(e.to);
                }
            }
        }
        return level[t] >= 0;
    }

    float dfs(int v, int t, float f) {
        if (v == t) return f;
        for (int& i = iter[v]; i < (int)edges[v].size(); i++) {
            Edge& e = edges[v][i];
            if (e.cap > 0 && level[v] < level[e.to]) {
                float d = dfs(e.to, t, f < e.cap ? f : e.cap);
                if (d > 0) {
                    e.cap -= d;
                    edges[e.to][e.rev].cap += d;
                    return d;
                }
            }
        }
        return 0;
    }

    float maxflow(int s, int t) {
        float flow = 0;
        while (bfs(s, t)) {
            std::fill(iter.begin(), iter.end(), 0);
            float f;
            while ((f = dfs(s, t, 1e30f)) > 0) flow += f;
        }
        return flow;
    }
};

}  // namespace

extern "C" {

float grid_mincut(int H, int W, const float* cap_h, const float* cap_v,
                  const float* excess, const uint8_t* node,
                  uint8_t* out_labels) {
    const int n = H * W;
    const int S = n, T = n + 1;
    Graph g(n + 2);

    for (int y = 0; y < H; y++) {
        for (int x = 0; x < W; x++) {
            const int u = y * W + x;
            if (!node[u]) continue;
            if (x + 1 < W && node[u + 1] && cap_h[u] > 0)
                g.add_edge(u, u + 1, cap_h[u], cap_h[u]);
            if (y + 1 < H && node[u + W] && cap_v[u] > 0)
                g.add_edge(u, u + W, cap_v[u], cap_v[u]);
            if (excess[u] > 0)
                g.add_edge(S, u, excess[u], 0.0f);
            else if (excess[u] < 0)
                g.add_edge(u, T, -excess[u], 0.0f);
        }
    }

    const float flow = g.maxflow(S, T);

    // SOURCE side = reachable from S in the residual graph
    std::memset(out_labels, 0, n);
    std::vector<uint8_t> seen(n + 2, 0);
    std::queue<int> q;
    seen[S] = 1;
    q.push(S);
    while (!q.empty()) {
        int v = q.front();
        q.pop();
        for (const Edge& e : g.edges[v]) {
            if (e.cap > 0 && !seen[e.to]) {
                seen[e.to] = 1;
                if (e.to < n) out_labels[e.to] = 1;
                q.push(e.to);
            }
        }
    }
    return flow;
}

}  // extern "C"
