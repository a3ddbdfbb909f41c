"""data"""
