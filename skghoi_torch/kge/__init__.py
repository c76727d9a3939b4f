"""Knowledge-graph embedding models (TransH so far)."""
