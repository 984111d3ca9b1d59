"""Seeded inputs: the CAD banks' procedural cars and the camera-stream scene pools."""
