"""Model definitions for the port: plain functions over nested-dict params."""
