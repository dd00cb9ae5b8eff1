from .pose_graph import (
    optimize_pose_graph,
    sequential_edges,
    detect_loop_closures,
    detect_loop_closures_batched,
    register_pairs_batched,
    register_pairs_batched_plain,
    keyframe_normals,
    keyframe_insert,
)

__all__ = ["optimize_pose_graph", "sequential_edges", "detect_loop_closures",
           "detect_loop_closures_batched", "register_pairs_batched",
           "register_pairs_batched_plain", "keyframe_normals",
           "keyframe_insert"]
