"""SLAM backend: SE(3) pose graph, point-to-plane scan factors, sliding-window
SLAM with loop closure, and map assembly."""
