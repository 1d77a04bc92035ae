"""Segment-level carry algebra (host builders); multi-device execution is
not ported yet (ROADMAP Queue 1 item 14)."""
